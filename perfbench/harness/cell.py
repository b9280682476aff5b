"""One run of one cell: set-up, the measured window, its metrics, the check.

Set-up (``setup_s``, from the start of the process): each column of the
configuration is generated on the device from the seed, compressed there
by ``alp_tpu_torch.compress_device`` and planned once
(``col.plan(device)``); then every template of the traffic mix is called
twice, so that every kernel is built and every kept-plan structure made
before the window.  The window is a closed loop of one client
(``window.closed_loop``), traced with ``--trace 1``.  After it the peak
memory is read, the program's state is freed and the kept answers are
checked against the plain reference (``check.check``).

``memory_peak_bytes`` is the window's peak: the allocator's peak is reset
once warm-up has ended, so set-up's transients (a raw column,
``compress_device``'s scratch) are reported apart, as
``setup_peak_bytes``.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from . import check, roofline, trace, traffic, window

MIN_CYCLES = 3          # the window runs at least three cycles of the mix


@dataclasses.dataclass
class Run:
    """What the metric readers (``metrics/<name>.py``: ``read(run)``) see."""
    window: window.Window
    setup_s: float
    infos: dict               # column -> roofline.ColumnInfo
    least_s: list             # each record's least seconds, or None
    trace: trace.Trace | None
    device_name: str


def columns_of(mix: dict) -> list:
    return list(dict.fromkeys(t.column for t in traffic.templates(mix)))


def make_values(bench, config: dict, seed: int, device):
    """``values_of(column)``: the column's generated values, in the
    configuration's ``dtype`` (the generators draw float64)."""
    gen = bench.generator(config["generator"])
    n = int(config["rows"])
    dtype = getattr(torch, config["dtype"])

    def seed_of(name):
        return traffic.subseed(seed, "data", name)

    def values_of(column):
        return gen.column(column, config, n, seed_of, device).to(dtype)

    return values_of


def _caller(ops: dict, cols: dict, device):
    def call(req, span):
        op = ops[req.op]
        answer = op.call(cols[req.column], req.params, device, span)
        counters = op.counters() if hasattr(op, "counters") else {}
        return answer, counters
    return call


def keeper(ops: dict, mix: dict, seed: int):
    """Keep every answer, or for an op with ``KEEP = "sample"`` the answer
    of one occurrence of each template, drawn from the seed among the
    first ``MIN_CYCLES``."""
    rng = np.random.default_rng(traffic.subseed(seed, "sample"))
    pick = {t.name: int(rng.integers(MIN_CYCLES))
            for t in traffic.templates(mix)}
    seen = collections.Counter()

    def keep(req):
        if getattr(ops[req.op], "KEEP", "all") != "sample":
            return True
        seen[req.template] += 1
        return seen[req.template] - 1 == pick[req.template]

    return keep


def warm_up(mix: dict, seed: int, call) -> None:
    """Call every template twice, holding the first answers while the
    second run: every kernel and kept structure is made, and the device
    allocator holds as many output buffers as the window keeps."""
    names = {t.name for t in traffic.templates(mix)}
    seen, held = collections.Counter(), {}
    for req in traffic.requests(mix, traffic.subseed(seed, "warm-up")):
        if seen[req.template] < 2:
            answer, _ = call(req, window.no_span)
            if not seen[req.template]:
                held[req.template] = answer
            seen[req.template] += 1
            del answer
        if all(seen[n] >= 2 for n in names):
            break
    del held


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(bench, wl, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> tuple:
    """One run; returns (the result line's dict, the check's lines).
    ``t_start`` is ``time.perf_counter()`` at the start of the process."""
    device = torch.device(device)
    import alp_tpu_torch
    config, mix = wl.config, wl.traffic
    values_of = make_values(bench, config, seed, device)
    ops = {t.op: bench.op(t.op) for t in traffic.templates(mix)}
    cols, infos = {}, {}
    for name in columns_of(mix):
        values = values_of(name)
        cols[name] = alp_tpu_torch.compress_device(
            values=values, n_values=values.numel(), device=device)
        infos[name] = roofline.column_info(cols[name], values)
        del values
        cols[name].plan(device)
    call = _caller(ops, cols, device)
    warm_up(mix, seed, call)
    sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = 0
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    stream = traffic.requests(mix, seed)
    keep = keeper(ops, mix, seed)
    min_requests = MIN_CYCLES * traffic.cycle_length(mix)
    prof = None
    if traced:
        prof = trace.profiler(device)
        prof.__enter__()
    try:
        win = window.closed_loop(stream, call, seconds, min_requests, keep,
                                 torch.profiler.record_function if traced
                                 else window.no_span)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    tr = trace.read(prof) if traced else None
    del cols, call
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    least = [roofline.least_seconds(ops[r.op].work(infos[r.column],
                                                   r.params), name)
             for r in win.records]
    result = {"correct": False, "attempted": len(win.records),
              "failed": sum(not r.ok for r in win.records)}
    run_ = Run(win, setup_s, infos, least, tr, name)
    metrics = {}
    for m in (wl.per_layer if traced else wl.end_to_end):
        got = bench.metric(m["name"]).read(run_)
        if got is not None:
            metrics[m["name"]] = {"value": got, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": name, "count": wl.chips, "memory_peak_bytes": int(peak),
        "setup_peak_bytes": int(setup_peak)}
    if tr is not None and tr.requests:
        lo, hi = tr.window
        result["device"]["busy_s"] = tr.busy_us() * 1e-6
        result["device"]["window_s"] = (hi - lo) * 1e-6
        result["breakdown"] = trace.breakdown(tr)
    numbers, checked = check.check(win.records, win.answers,
                                   ops.__getitem__, values_of)
    result["correct"] = check.passed(numbers)
    result["checks"] = {n: {"value": v, "limit": limit}
                        for n, (v, limit) in numbers.items()}
    lines = [f"checked {checked} answers of {result['attempted']} requests"]
    if tr is not None:
        early, lag, stray = tr.clocks()
        lines.insert(0, f"trace: {early} device operations start before "
                     f"their launch (least lag {lag} us); {stray} launched "
                     f"outside every request")
    return result, lines + check.lines(numbers)
