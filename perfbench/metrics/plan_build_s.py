"""plan_build_s: seconds the process spent in the program's
``alp.plan.build`` spans up to the window's end (set-up's: the cells keep
their plans), from ``alp_tpu_torch.tracing.totals()``, host clock.  None
where the program has no such span."""

from harness import spans


def read(run):
    got = (spans.program_totals() or {}).get("alp.plan.build")
    return None if got is None else got["seconds"]
