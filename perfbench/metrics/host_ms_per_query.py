"""host_ms_per_query: a request's wall (its span in the trace) less the
device-busy time inside it, a mean over the window's requests, in ms."""


def read(run):
    tr = run.trace
    if tr is None or not tr.requests or not tr.device:
        return None
    stats = tr.per_request()
    return sum(w - b for w, b, _ in stats) / len(stats) * 1e-3
