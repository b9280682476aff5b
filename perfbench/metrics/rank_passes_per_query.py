"""rank_passes_per_query: ``alp_tpu_torch.engine.LAST_RANK_PASSES`` read
after each QUANTILE or MEDIAN request (the ops' ``counters``), a mean
over those requests of the window."""


def read(run):
    got = [r.counters["rank_passes"] for r in run.window.records
           if "rank_passes" in r.counters]
    return sum(got) / len(got) if got else None
