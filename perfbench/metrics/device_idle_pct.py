"""device_idle_pct: the share of the traced window (first request's start
to the last one's end) in which no kernel, copy or set of its requests
ran on the device (``torch.profiler``'s CUDA activity)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.requests or not tr.device:
        return None
    lo, hi = tr.window
    return 100.0 * (1.0 - tr.busy_us() / (hi - lo))
