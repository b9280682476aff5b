"""fetches_per_query: the program's ``alp.fetch.*`` spans inside each
request's span (each a place where the host waited on the device: a copy
to the host, an implicit wait, an upload), a mean over the window's
requests.  None where no request holds a program span."""

from harness import spans


def read(run):
    tr = run.trace
    if tr is None or not tr.requests:
        return None
    per = spans.in_requests(tr)
    if not any(per):
        return None
    return sum(len(spans.named(sp, ("alp.fetch.",))) for sp in per) / len(per)
