"""The program's own spans inside the traced window's requests.

The port names its host work with spans whose names start ``alp.``
(``alp_tpu_torch.tracing``): the engine's stages (``alp.engine.*``), the
waits on the device (``alp.fetch.*``), the decode plan (``alp.plan.*``),
the kernel wrappers (``alp.kernel.*``).  While the profiler records they
are ``record_function``s, so they reach the trace as the benchmark's own
spans do (``Trace.spans``).  A program without them leaves every list
here empty.  Times are the profiler's microseconds.
"""

from __future__ import annotations

import bisect

PROGRAM = "alp."


def in_requests(tr) -> list:
    """For each request of the trace, in order, the program's spans that
    lie inside its span: [(start, end, name)], sorted by start."""
    starts = [s for s, _, _ in tr.requests]
    out = [[] for _ in tr.requests]
    for sp in tr.spans:
        if not sp[2].startswith(PROGRAM):
            continue
        i = bisect.bisect_right(starts, sp[0]) - 1
        if i >= 0 and sp[1] <= tr.requests[i][1]:
            out[i].append(sp)
    return out


def named(spans: list, prefixes) -> list:
    """The spans whose names start with one of ``prefixes``."""
    return [sp for sp in spans if sp[2].startswith(tuple(prefixes))]


def union(spans: list) -> list:
    """The union of the spans' intervals: sorted, disjoint [start, end]."""
    out = []
    for s, e, *_ in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def measure(intervals: list) -> float:
    return sum(e - s for s, e in intervals)


def overlap(a: list, b: list) -> float:
    """The length that two unions (``union``) share."""
    i = j = 0
    got = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            got += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return got


def program_totals():
    """``alp_tpu_torch.tracing.totals()["spans"]`` of this process, or None
    where the program has no such registry."""
    try:
        from alp_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.totals()["spans"]
