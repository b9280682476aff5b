"""device_ops_per_query: kernels, copies and sets launched inside a
request's span in the trace, a mean over the window's requests."""


def read(run):
    tr = run.trace
    if tr is None or not tr.requests or not tr.device:
        return None
    stats = tr.per_request()
    return sum(n for _, _, n in stats) / len(stats)
