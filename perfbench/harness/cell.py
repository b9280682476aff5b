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

A cell whose ``chips`` W is above 1 runs on W ranks (``harness/ranks.py``),
each on its own card: ``run_ranks``.  Each rank generates, compresses and
plans only its own run of whole rowgroups (its configuration's generator
gives ``rows(name, config, lo, hi, seed_of, device)``, values that depend
on the seed and the row alone), and its ops take a fifth argument,
``ranks``, and answer the whole question on every rank.  Rank 0's clock,
records and trace are the cell's.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import time

import numpy as np
import torch

from . import check, ranks as ranks_mod, roofline, trace, traffic, window

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


def _seed_of(seed: int):
    def seed_of(name):
        return traffic.subseed(seed, "data", name)
    return seed_of


def make_values(bench, config: dict, seed: int, device):
    """``values_of(column)``: the column's generated values, in the
    configuration's ``dtype`` (the generators draw float64)."""
    gen = bench.generator(config["generator"])
    n = int(config["rows"])
    dtype = getattr(torch, config["dtype"])
    seed_of = _seed_of(seed)

    def values_of(column):
        return gen.column(column, config, n, seed_of, device).to(dtype)

    return values_of


def rows_generator(bench, config: dict):
    """The configuration's generator, which a cell on several cards needs
    to give ``rows``."""
    gen = bench.generator(config["generator"])
    if not callable(getattr(gen, "rows", None)):
        raise ValueError(f"generator {config['generator']!r} has no "
                         f"rows(name, config, lo, hi, seed_of, device): "
                         f"no cell on several cards can use it")
    return gen


def make_share_values(bench, config: dict, seed: int, rows: tuple, device):
    """``values_of(column)``: the generated values of rows [lo, hi) of the
    column, in the configuration's ``dtype``."""
    gen = rows_generator(bench, config)
    lo, hi = rows
    dtype = getattr(torch, config["dtype"])
    seed_of = _seed_of(seed)

    def values_of(column):
        return gen.rows(column, config, lo, hi, seed_of, device).to(dtype)

    return values_of


def _caller(ops: dict, cols: dict, device, *ranks):
    def call(req, span):
        op = ops[req.op]
        answer = op.call(cols[req.column], req.params, device, span, *ranks)
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


def _setup(mix: dict, values_of, device) -> tuple:
    """Generate, compress and plan each column of ``mix``: ({column:
    CompressedColumn}, {column: roofline.ColumnInfo})."""
    import alp_tpu_torch
    cols, infos = {}, {}
    for name in columns_of(mix):
        values = values_of(name)
        cols[name] = alp_tpu_torch.compress_device(
            values=values, n_values=values.numel(), device=device)
        infos[name] = roofline.column_info(cols[name], values)
        del values
        cols[name].plan(device)
    return cols, infos


def _peaks(device) -> int:
    """The allocator's peak since the last reset, which it resets."""
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def _profiled(traced: bool, device, loop):
    """``loop(span)``'s window, under the profiler when ``traced``; and the
    trace (or None)."""
    if not traced:
        return loop(window.no_span), None
    with trace.profiler(device) as prof:
        win = loop(torch.profiler.record_function)
    return win, prof


def _metrics(bench, wl, traced: bool, run_: Run) -> dict:
    metrics = {}
    for m in (wl.per_layer if traced else wl.end_to_end):
        got = bench.metric(m["name"]).read(run_)
        if got is not None:
            metrics[m["name"]] = {"value": got, "unit": m["unit"]}
    return metrics


def _device_name(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _traced(tr) -> dict:
    """``busy_s`` and ``window_s`` of a trace with requests."""
    if tr is None or not tr.requests:
        return {}
    lo, hi = tr.window
    return {"busy_s": tr.busy_us() * 1e-6, "window_s": (hi - lo) * 1e-6}


def _finish(result: dict, numbers: dict, checked: int, tr) -> list:
    """Put the check's verdict and numbers last in ``result``; returns the
    lines for standard error."""
    result["correct"] = check.passed(numbers)
    result["checks"] = {n: {"value": v, "limit": limit}
                        for n, (v, limit) in numbers.items()}
    lines = [f"checked {checked} answers of {result['attempted']} requests"]
    if tr is not None:
        early, lag, stray = tr.clocks()
        lines.insert(0, f"trace: {early} device operations start before "
                     f"their launch (least lag {lag} us); {stray} launched "
                     f"outside every request")
    return lines + check.lines(numbers)


def run(bench, wl, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> tuple:
    """One run; returns (the result line's dict, the check's lines).
    ``t_start`` is ``time.perf_counter()`` at the start of the process."""
    device = torch.device(device)
    config, mix = wl.config, wl.traffic
    values_of = make_values(bench, config, seed, device)
    ops = {t.op: bench.op(t.op) for t in traffic.templates(mix)}
    cols, infos = _setup(mix, values_of, device)
    call = _caller(ops, cols, device)
    warm_up(mix, seed, call)
    sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = _peaks(device)

    stream = traffic.requests(mix, seed)
    keep = keeper(ops, mix, seed)
    min_requests = MIN_CYCLES * traffic.cycle_length(mix)
    win, prof = _profiled(traced, device, lambda span: window.closed_loop(
        stream, call, seconds, min_requests, keep, span))
    peak = _peaks(device)
    tr = trace.read(prof) if traced else None
    del cols, call
    name = _device_name(device)
    least = [roofline.least_seconds(ops[r.op].work(infos[r.column],
                                                   r.params), name)
             for r in win.records]
    result = {"correct": False, "attempted": len(win.records),
              "failed": sum(not r.ok for r in win.records)}
    result["metrics"] = _metrics(bench, wl, traced,
                                 Run(win, setup_s, infos, least, tr, name))
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": name, "count": wl.chips, "memory_peak_bytes": int(peak),
        "setup_peak_bytes": int(setup_peak), **_traced(tr)}
    if tr is not None and tr.requests:
        result["breakdown"] = trace.breakdown(tr)
    numbers, checked = check.check(win.records, win.answers,
                                   ops.__getitem__, values_of)
    return result, _finish(result, numbers, checked, tr)


def run_ranks(bench, wl, seed: int, seconds: float, traced: bool, ranks,
              t_start: float):
    """One run of a cell on ``ranks.world`` cards, called on every rank
    with its ``ranks.Ranks``.  Every rank draws the same stream and
    warm-up; warm-up ends in a barrier.  In the window each request
    carries beside it a broadcast of rank 0's decision whether another
    follows, on the harness's gloo group (``window.lockstep_loop``, spans
    ``bench.ranks.step``).  After it the ranks exchange the requests that
    failed, and one failed on any rank has failed; each rank frees its
    state and generates its share again for the check.  Returns, on
    rank 0, (the result line's dict, the check's lines); elsewhere None.

    ``infos`` are the whole column's (the shares' counts summed), so a
    rate counts every rank's bytes; a request's least time is the whole
    work at W cards' rates.  ``device`` gives each rank's peaks (and
    traced, its busy and window seconds) under ``ranks``; its
    ``memory_peak_bytes`` and ``setup_peak_bytes`` are the largest, its
    ``busy_s`` the ranks' mean and its ``window_s`` rank 0's."""
    device = ranks.device
    config, mix = wl.config, wl.traffic
    values_of = make_share_values(bench, config, seed, ranks.rows, device)
    ops = {t.op: bench.op(t.op) for t in traffic.templates(mix)}
    cols, infos = _setup(mix, values_of, device)
    shares = ranks.gather(infos)
    call = _caller(ops, cols, device, ranks)
    warm_up(mix, seed, call)
    sync(device)
    ranks.barrier()
    setup_s = time.perf_counter() - t_start
    setup_peak = _peaks(device)

    stream = traffic.requests(mix, seed)
    keep = keeper(ops, mix, seed)
    min_requests = MIN_CYCLES * traffic.cycle_length(mix)

    def loop(span):
        return window.lockstep_loop(stream, call, seconds, min_requests,
                                    keep, span, ranks.decide,
                                    ranks_mod.STEP_SPAN)

    win, prof = _profiled(traced, device, loop)
    peak = _peaks(device)
    tr = trace.read(prof) if traced else None
    del cols, call
    failed = set().union(*ranks.all_gather(
        [r.index for r in win.records if not r.ok]))
    for r in win.records:       # a request failed on any rank has failed
        if r.index in failed and r.ok:
            r.ok, r.error = False, "failed on another rank"
            win.answers.pop(r.index, None)
    mine = {"memory_peak_bytes": int(peak),
            "setup_peak_bytes": int(setup_peak), **_traced(tr)}
    digests = {i: check.digest(a) for i, a in win.answers.items()}
    gathered = ranks.gather((mine, digests))
    expected = check.joined(ranks, ops.__getitem__,
                            check.questions(win.records, win.answers,
                                            ops.__getitem__), values_of)
    step_us = ranks.step_ns / max(ranks.steps, 1) * 1e-3
    if ranks.rank != 0:
        print(f"rows [{ranks.rows[0]}, {ranks.rows[1]}), "
              f"{len(win.records)} requests, {step_us:.1f} us of "
              f"{ranks_mod.STEP_SPAN} a request, "
              f"{mine}", file=sys.stderr, flush=True)
        return None

    infos = {name: roofline.summed([s[name] for s in shares])
             for name in infos}
    name = _device_name(device)
    least = [roofline.least_seconds(ops[r.op].work(infos[r.column],
                                                   r.params), name,
                                    chips=ranks.world)
             for r in win.records]
    result = {"correct": False, "attempted": len(win.records),
              "failed": sum(not r.ok for r in win.records)}
    result["metrics"] = _metrics(bench, wl, traced,
                                 Run(win, setup_s, infos, least, tr, name))
    each = [m for m, _ in gathered]
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": name, "count": ranks.world}
    for key in ("memory_peak_bytes", "setup_peak_bytes"):
        dev[key] = max(m[key] for m in each)
    if "busy_s" in mine:
        busy = [m["busy_s"] for m in each if "busy_s" in m]
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = mine["window_s"]
    dev["ranks"] = each
    result["device"] = dev
    if tr is not None and tr.requests:
        result["breakdown"] = trace.breakdown(tr)
    numbers, checked = check.judge(win.records, win.answers,
                                   ops.__getitem__,
                                   lambda column, qs: expected[column])
    numbers[check.DISAGREE] = (
        check.disagreeing(digests, [d for _, d in gathered[1:]]), 0)
    lines = _finish(result, numbers, checked, tr)
    lines.insert(0, f"ranks: {ranks.steps} requests in lockstep, "
                 f"{step_us:.1f} us of {ranks_mod.STEP_SPAN} a request "
                 f"(host clock, rank 0)")
    if tr is not None:
        spans = [e - s for s, e, n in tr.spans if n == ranks_mod.STEP_SPAN]
        lines.insert(1, f"trace: {len(spans)} {ranks_mod.STEP_SPAN} spans, "
                     f"{sum(spans) / max(len(win.records), 1):.1f} us a "
                     f"request")
    return result, lines
