"""The traced window: ``torch.profiler`` over the loop, read back as plain
intervals.

With ``--trace 1`` the window runs under ``torch.profiler`` (CPU and CUDA
activity).  The benchmark's own spans (``record_function``) mark each
request (``request.<template>``) and each call into the program inside
it (``engine.query_sum``, ``plan.run``, ...).  After the window the trace
is exported once (a Chrome trace in ``TMPDIR``, deleted after reading)
and reduced to:

* the device's operations: kernels, copies and sets, as intervals, each
  with the host time of the call that launched it;
* the spans, and among them the requests, in order.

Timestamps are the profiler's microseconds.  A device operation belongs
to the request in whose span it was launched.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
REQUEST = "request."
TOP = 10                # entries of each list of the breakdown


@dataclasses.dataclass
class Trace:
    """``device``: (start_us, end_us, name, launch_us) of each kernel, copy
    or set, sorted by start; ``launch_us`` is the host time of the call
    that launched it (the runtime or driver event of the same
    correlation id), or None.  ``spans``: (start_us, end_us, name), sorted;
    ``requests``: the request spans among them, in order."""
    device: list
    spans: list
    requests: list

    def __post_init__(self):
        self.request_ops = self._attribute()

    def _attribute(self) -> list:
        """The device operations of each request: those launched inside
        its span.  The device's clock may stand off the host's by some
        microseconds, so an operation goes by its launch, or where the
        trace has none, by its start."""
        starts = [s for s, _, _ in self.requests]
        ops = [[] for _ in self.requests]
        for op in self.device:
            at = op[3] if op[3] is not None else op[0]
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= self.requests[i][1]:
                ops[i].append(op)
        return ops

    @property
    def window(self) -> tuple:
        return self.requests[0][0], self.requests[-1][1]

    @staticmethod
    def merged(ops: list) -> list:
        """The union of the intervals of ``ops`` (sorted by start)."""
        out = []
        for s, e, *_ in ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_us(self) -> float:
        """The device's busy time over the window's requests."""
        every = sorted(op for ops in self.request_ops for op in ops)
        return sum(e - s for s, e in self.merged(every))

    def per_request(self) -> list:
        """(wall, device-busy, device operations) of each request span,
        in microseconds and a count."""
        return [(e - s, sum(b - a for a, b in self.merged(ops)), len(ops))
                for (s, e, _), ops in zip(self.requests, self.request_ops)]

    def gaps(self) -> list:
        """The device's idle intervals between the window's first and last
        operations: (start, end)."""
        every = sorted(op for ops in self.request_ops for op in ops)
        merged = self.merged(every)
        return [(a[1], b[0]) for a, b in zip(merged, merged[1:])]

    def clocks(self) -> tuple:
        """(device operations whose start on the device's clock precedes
        their launch on the host's, the least start-less-launch in us,
        device operations launched outside every request): how far the
        two clocks stand apart, and what no request owns."""
        lags = [s - at for s, _, _, at in self.device if at is not None]
        owned = sum(len(ops) for ops in self.request_ops)
        return (sum(lag < 0 for lag in lags), min(lags, default=0.0),
                len(self.device) - owned)

    def host_at(self, t: float) -> str:
        """The innermost span that holds time ``t``: what the host was
        doing then."""
        best = None
        for s, e, name in self.spans:
            if s > t:
                break
            if e >= t and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else "host.between_requests"


def profiler(device):
    """A ``torch.profiler.profile`` of the host and, on a card, the
    device."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  profile_memory=False, with_stack=False)


def read(prof) -> Trace:
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return from_events(events)


def from_events(events: list) -> Trace:
    """A ``Trace`` from Chrome trace events (``ph`` "X")."""
    device, spans, launch = [], [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        cat = ev.get("cat", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((s, e, str(ev.get("name", "")), corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launch[corr] = s
        elif cat == "user_annotation":
            spans.append((s, e, str(ev.get("name", ""))))
    device = sorted((s, e, n, launch.get(c)) for s, e, n, c in device)
    spans.sort()
    requests = [s for s in spans if s[2].startswith(REQUEST)]
    return Trace(device, spans, requests)


def breakdown(trace: Trace) -> dict:
    """The device operations of the window's requests that took most time
    (summed by name), and the longest idle gaps named by what the host
    was doing as the gap began, in seconds."""
    by_name = {}
    for ops in trace.request_ops:
        for s, e, name, _ in ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:TOP]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[trace.host_at(s), (e - s) * 1e-6]
                          for s, e in gaps]}
