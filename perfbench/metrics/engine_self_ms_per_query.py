"""engine_self_ms_per_query: the host's own time in the engine, inside each
request's span: the union of the program's ``alp.engine.*`` spans less
what its ``alp.fetch.*`` (waits on the device), ``alp.kernel.*`` (kernel
wrappers) and ``alp.plan.*`` (decode plan) spans cover, a mean over the
window's requests, in ms.  None where no request holds an engine span."""

from harness import spans

BELOW = ("alp.fetch.", "alp.kernel.", "alp.plan.")


def read(run):
    tr = run.trace
    if tr is None or not tr.requests:
        return None
    per = spans.in_requests(tr)
    if not any(spans.named(sp, ("alp.engine.",)) for sp in per):
        return None
    total = 0.0
    for sp in per:
        engine = spans.union(spans.named(sp, ("alp.engine.",)))
        below = spans.union(spans.named(sp, BELOW))
        total += spans.measure(engine) - spans.overlap(engine, below)
    return total / len(per) * 1e-3
