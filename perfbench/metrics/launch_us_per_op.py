"""launch_us_per_op: the mean duration of the program's ``alp.kernel.*``
spans inside the window's requests (a kernel wrapper's host work, from its
checks to the return of its launch), in us.  None where no request holds
one."""

from harness import spans


def read(run):
    tr = run.trace
    if tr is None or not tr.requests:
        return None
    got = [e - s for sp in spans.in_requests(tr)
           for s, e, _ in spans.named(sp, ("alp.kernel.",))]
    return sum(got) / len(got) if got else None
