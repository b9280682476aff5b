"""roofline_pct: the least time of the work the window's requests need
(``harness.roofline``: the compressed column read once, decoded bytes
written once, at the memory bandwidth; the operations a value at the
issue rates; the larger of the two a request), over the device-busy time
inside their spans in the trace."""


def read(run):
    tr = run.trace
    if tr is None or len(tr.requests) != len(run.window.records):
        return None
    if any(s is None for s in run.least_s):
        return None
    busy = sum(b for _, b, _ in tr.per_request())
    if busy <= 0:
        return None
    return 100.0 * sum(run.least_s) / (busy * 1e-6)
