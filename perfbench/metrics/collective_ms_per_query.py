"""collective_ms_per_query: rank 0's time in the program's collectives
inside each request: the union of its ``alp.parallel.all_gather`` and
``alp.parallel.all_reduce`` spans (``alp_tpu_torch.parallel``: the call of
each collective on the host) inside the request's span, a mean over the
window's requests, in ms.  None where no request holds one."""

from harness import spans

COLLECTIVES = ("alp.parallel.all_gather", "alp.parallel.all_reduce")


def read(run):
    tr = run.trace
    if tr is None or not tr.requests:
        return None
    per = [spans.named(sp, COLLECTIVES) for sp in spans.in_requests(tr)]
    if not any(per):
        return None
    return sum(spans.measure(spans.union(sp)) for sp in per) / len(per) * 1e-3
