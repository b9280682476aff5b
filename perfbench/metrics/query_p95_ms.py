"""query_p95_ms: the nearest-rank 95th percentile of every request's
latency in the window (host clock, call to answer), a failed request
counting as infinite."""

import math

from harness import window


def read(run):
    p95 = window.percentile(window.latencies(run.window), 95)
    return None if math.isinf(p95) else p95 * 1e3
