"""Rank worker of the port's sharded tests (``tests/test_torch_parallel.py``
and ``tests/test_torch_conformance.py`` on the CPU over gloo,
``tests/test_torch_cuda.py`` on cards over NCCL).

It imports neither JAX nor ``alp_tpu``, so that spawned ranks load
neither.  ``spawn_ranks`` starts ``world`` processes that each run
:func:`run_rank`: join the process group by a ``file://`` rendezvous, build
the mesh, run every sharded path on the columns of :func:`columns` and
pickle the results to ``out_dir/rank<r>.pkl``; it returns every rank's
results, or raises when a rank fails or outlasts the deadline.
:func:`run_groupby_rank` runs the sharded GROUP-BY alone, on the cases of
fault F3 (:func:`f3_groupby_cases`); :func:`run_share_rank` the queries
on each rank's own ``ColumnShare`` (``tests/test_torch_share.py``);
:func:`run_trace_rank` a sharded SUM and COUNT WHERE under a profiler
(``tests/test_torch_tracing.py``).
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import pickle
import time

import numpy as np

COLUMNS = ("bench_bw20_food_prices", "f64_alp_rd", "f64_mixed_alp_rd",
           "f32_alp", "f32_alp_rd", "f64_specials_tail")
N_VECTORS = 250                    # 2.5 rowgroups: both schemes when mixed
GROUPS = 16
COUNT_RANGE = (10.0, 50.0)
JOIN_ROWS = 4                      # synthetic SUM rows a rank


def columns() -> dict:
    from alp_tpu_torch.columns import route_columns
    cols = route_columns(np.random.default_rng(3), N_VECTORS)
    return {name: cols[name] for name in COLUMNS}


def fsum_reference(x: np.ndarray) -> float:
    """``math.fsum`` of the values, with IEEE's NaN and infinity rules."""
    x = x.astype(np.float64)
    pinf, ninf = bool(np.isposinf(x).any()), bool(np.isneginf(x).any())
    if np.isnan(x).any() or (pinf and ninf):
        return math.nan
    if pinf or ninf:
        return math.inf if pinf else -math.inf
    return math.fsum(x.tolist())


def group_keys(n: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, GROUPS, n)


def step_problem() -> tuple:
    """The encode step's inputs of ``tests/test_parallel.py::problem``:
    16 vectors of 2-decimal values, candidates (14, 12) and (14, 13)."""
    rng = np.random.default_rng(0)
    n_vec = 16
    values = np.round(rng.uniform(-50, 50, size=(n_vec, 1024)), 2)
    combos = np.zeros((n_vec, 5, 2), np.int32)
    combos[:, 0] = (14, 12)
    combos[:, 1] = (14, 13)
    return values, combos, np.full(n_vec, 2, np.int32)


def join_rows(rank: int, width: int) -> np.ndarray:
    """Synthetic int64 SUM rows [JOIN_ROWS, width] of ``rank``: every window
    total within 2^20 of +-2^62, so that four of them overflow int64; the
    NaN / +Inf / -Inf counts small."""
    rng = np.random.default_rng([7, rank])
    w = width - 3
    sign = np.where(rng.random((JOIN_ROWS, w)) < 0.25, -1, 1)
    rows = np.zeros((JOIN_ROWS, width), np.int64)
    rows[:, :w] = sign * (np.int64(1 << 62)
                          - rng.integers(0, 1 << 20, (JOIN_ROWS, w)))
    rows[:, w:] = rng.integers(0, 5, (JOIN_ROWS, 3))
    return rows


F3_KINDS = ("plain", "nan", "pinf", "ninf", "both")
F3_VALUES = 100 * 1024 + 500           # a rowgroup and a tail: two shares


def f3_column(cell: np.ndarray, kinds, dense: bool, seed: int) -> np.ndarray:
    """Values of rows in groups ``cell`` (ids into ``kinds``): 2-decimal
    values, and in each group of a kind other than "plain" finite values
    of 9e307 and 1e308 whose sum passes DBL_MAX (every row when ``dense``,
    which makes ALP_RD rowgroups, else four rows: ALP exceptions) and its
    special at its first row: NaN ("nan"), +Inf ("pinf"), -Inf ("ninf"),
    or +Inf there and -Inf at its last row ("both").  A kind "overflow"
    has the large values and no special."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(-50, 50, len(cell)), 2)
    for c, kind in enumerate(kinds):
        rows = np.flatnonzero(cell == c)
        if kind == "plain" or not rows.size:
            continue
        big = rows if dense else rows[:4]
        x[big] = np.where(np.arange(len(big)) % 2, 1e308, 9e307)
        if kind in ("nan", "pinf", "ninf", "both"):
            x[rows[0]] = {"nan": np.nan, "ninf": -np.inf}.get(kind, np.inf)
        if kind == "both":
            x[rows[-1]] = -np.inf
    return x


def f3_groupby_cases() -> dict:
    """name -> (values, keys, G): GROUP-BY cases of fault F3 (a group with
    NaN or an infinity beside finite values past DBL_MAX) for the sharded
    path, in a rowgroup and a tail (two rowgroups, so two ranks' shares)."""
    out = {}
    for G, dense in ((5, True), (5, False), (300, True)):
        keys = np.random.default_rng(G).integers(0, G, F3_VALUES)
        kinds = [F3_KINDS[g % 5] for g in range(G)]
        out[f"G{G}_{'dense' if dense else 'sparse'}"] = (
            f3_column(keys, kinds, dense, G), keys, G)
    return out


def run_groupby_rank(rank: int, world: int, rendezvous: str,
                     device_type: str, out_dir: str) -> None:
    """``sharded_groupby`` of every case of :func:`f3_groupby_cases`, each
    answer or the name of the exception it raised."""
    import torch.distributed as dist

    import alp_tpu_torch
    from alp_tpu_torch import parallel as par

    _join(rank, world, rendezvous, device_type)
    try:
        mesh = par.make_mesh(world, device_type)
        res = {"rank": rank, "world": world, "groupby": {}}
        for name, (x, keys, G) in f3_groupby_cases().items():
            try:
                res["groupby"][name] = par.sharded_groupby(
                    mesh, alp_tpu_torch.compress(x), keys, G)
            except (OverflowError, ValueError) as e:
                res["groupby"][name] = type(e).__name__
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _join(rank: int, world: int, rendezvous: str, device_type: str) -> None:
    import torch
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))


def run_rank(rank: int, world: int, rendezvous: str, device_type: str,
             out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    import alp_tpu_torch
    from alp_tpu_torch import parallel as par
    from alp_tpu_torch.kernels import exact_sum as kes

    _join(rank, world, rendezvous, device_type)
    try:
        mesh = par.make_mesh(world, device_type)
        res = {"rank": rank, "world": world, "blob": {}, "decoded": {},
               "shards": {}, "sum": {}, "count": {}, "groupby": {}}
        for name, x in columns().items():
            col = alp_tpu_torch.compress(x)
            res["blob"][name] = alp_tpu_torch.compress(
                x, mesh=mesh).to_bytes()
            out = alp_tpu_torch.decompress(col, mesh=mesh)
            res["decoded"][name] = (str(out.device),
                                    out.cpu().numpy().tobytes())
            # the shares of every bucket decoded a rank (f32 too)
            res["shards"][name] = par.sharded_decode(
                mesh, col).cpu().numpy().tobytes()
            res["sum"][name] = par.sharded_exact_sum(mesh, col)
            res["count"][name] = par.sharded_filter_count(mesh, col,
                                                          *COUNT_RANGE)
            res["groupby"][name] = par.sharded_groupby(
                mesh, col, group_keys(len(x)), GROUPS)
        res["step"] = par.sharded_encode_decode_step(
            mesh, np.float64)(*step_problem())
        width = kes.WINDOWS[torch.int64] + 3
        rows = torch.from_numpy(join_rows(rank, width))
        res["join"] = par.join_rank_totals(mesh, rows, np.float64)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def share_rows(n: int, world: int, rank: int) -> tuple:
    """(lo, hi): rank ``rank``'s rows of an ``n``-row column, a run of
    whole rowgroups as ``parallel.share`` splits the rowgroups."""
    from alp_tpu_torch.parallel.sharded import RG_ROWS
    groups = -(-n // RG_ROWS)
    return (min(n, groups * rank // world * RG_ROWS),
            min(n, groups * (rank + 1) // world * RG_ROWS))


def share_range(x: np.ndarray) -> tuple:
    """A range of a column for COUNT WHERE and SUM WHERE: its finite
    values' 20th and 70th percentiles, rounded to two decimals."""
    lo, hi = np.quantile(x[np.isfinite(x)].astype(np.float64), [0.2, 0.7])
    return round(float(lo), 2), round(float(hi), 2)


REFUSALS = ("off_boundary", "overlap", "gap", "length", "dtype")
REFUSAL_ROWS = 8 * 100 * 1024 + 77        # nine rowgroups


def refused_share(case: str, world: int, rank: int) -> tuple:
    """(start, length, n_total, dtype) of rank ``rank``'s share in a
    refusal ``case``: the last rank's share moved off a rowgroup boundary
    (the rank before it made longer), moved back over the rank before it,
    moved on to leave a rowgroup out, or of another length or dtype of the
    column; ``None`` where the world has no such case."""
    from alp_tpu_torch.parallel.sharded import RG_ROWS
    n = REFUSAL_ROWS
    lo, hi = share_rows(n, world, rank)
    last = rank == world - 1
    dtype = np.float64
    if case == "off_boundary":
        if last:
            lo += 1000
        elif rank == world - 2:
            hi += 1000
    elif case == "overlap":
        if world < 2:
            return None
        lo -= RG_ROWS if last else 0
    elif case == "gap":
        lo += RG_ROWS if last else 0
    elif case == "length":
        if world < 2:
            return None
        n += int(last)
    elif case == "dtype":
        if world < 2:
            return None
        dtype = np.float32 if last else dtype
    return lo, hi - lo, n, dtype


def near_rows(rank: int, width: int, n_rows: int = JOIN_ROWS) -> np.ndarray:
    """Synthetic int64 SUM rows of ``rank`` whose windows below 32 lie
    within 2^20 of +-2^62 (four of them overflow int64) and whose other
    windows and special counts are 0, so that the exact sum is finite."""
    rows = join_rows(rank, width)[:n_rows]
    rows[:, 32:] = 0
    return rows


JOIN_N = 3 * 100 * 1024 + 5               # the mean's count of values
SHARE_THREADS = 2                         # a rank's intra-op threads


def run_share_rank(rank: int, world: int, rendezvous: str, device_type: str,
                   out_dir: str) -> None:
    """The share path: each rank compresses only its own rows of every
    column of :func:`columns` and queries its ``ColumnShare``; the refusal
    cases of :func:`refused_share`; the MEAN and SUM WHERE joins of
    :func:`near_rows`."""
    import types

    import torch
    import torch.distributed as dist

    import alp_tpu_torch
    from alp_tpu_torch import parallel as par
    from alp_tpu_torch.kernels import exact_sum as kes
    from alp_tpu_torch.parallel import sharded

    torch.set_num_threads(SHARE_THREADS)
    _join(rank, world, rendezvous, device_type)
    try:
        mesh = par.make_mesh(world, device_type)
        res = {"rank": rank, "world": world, "sum": {}, "mean": {},
               "count": {}, "filter_sum": {}, "refused": {}}
        for name, x in columns().items():
            lo, hi = share_rows(len(x), world, rank)
            col = alp_tpu_torch.compress(x[lo:hi]) if hi > lo else None
            sh = par.ColumnShare(col, lo, len(x), mesh, dtype=x.dtype)
            rng = share_range(x)
            res["sum"][name] = par.share_sum(sh)
            res["mean"][name] = par.share_mean(sh)
            res["count"][name] = par.share_filter_count(sh, *rng)
            res["filter_sum"][name] = par.share_filter_sum(sh, *rng)
        for case in REFUSALS:
            got = refused_share(case, world, rank)
            if got is None:
                continue
            start, length, n, dtype = got
            stand_in = types.SimpleNamespace(dtype=np.dtype(dtype),
                                             n_values=length)
            try:
                par.ColumnShare(stand_in, start, n, mesh)
                res["refused"][case] = None
            except ValueError as e:
                res["refused"][case] = str(e)
        width = kes.WINDOWS[torch.int64] + 3
        rows = torch.from_numpy(near_rows(rank, width))
        res["join_mean"] = sharded.join_mean(mesh, rows, np.float64, JOIN_N)
        res["join_filter_sum"] = sharded.join_filter_sum(mesh, rows,
                                                         np.float64)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


TRACE_COLUMN = "bench_bw20_food_prices"


def run_trace_rank(rank: int, world: int, rendezvous: str, device_type: str,
                   out_dir: str) -> None:
    """A sharded SUM and COUNT WHERE of :data:`TRACE_COLUMN` under a
    profiler, the share made first: the program's spans of the trace
    ((start, end, name)) and ``tracing.totals()``."""
    import json

    import torch
    import torch.distributed as dist

    import alp_tpu_torch
    from alp_tpu_torch import parallel as par
    from alp_tpu_torch import tracing

    torch.set_num_threads(SHARE_THREADS)
    _join(rank, world, rendezvous, device_type)
    try:
        mesh = par.make_mesh(world, device_type)
        col = alp_tpu_torch.compress(columns()[TRACE_COLUMN])
        par.column_share(col, mesh).plan
        tracing.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            total = par.sharded_exact_sum(mesh, col)
            count = par.sharded_filter_count(mesh, col, *COUNT_RANGE)
        path = os.path.join(out_dir, f"trace{rank}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
        events = events.get("traceEvents", events) \
            if isinstance(events, dict) else events
        names = ("alp.parallel.", "alp.fetch.parallel.")
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e["name"]) for e in events
                       if e.get("ph") == "X"
                       and e.get("cat") == "user_annotation"
                       and e["name"].startswith(names))
        res = {"rank": rank, "world": world, "sum": total, "count": count,
               "spans": spans, "totals": tracing.totals()}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, device_type: str, tmp_dir: str,
                deadline: float = 240.0, target=run_rank) -> list:
    """Run ``target`` (:func:`run_rank`, or another ``run_*_rank``) on
    ``world`` spawned processes; every rank's results in rank order.  A
    rank that exits nonzero fails the call; one still running at
    ``deadline`` seconds is killed, and so is every other."""
    ctx = multiprocessing.get_context("spawn")
    rendezvous = os.path.join(tmp_dir, "rendezvous")
    procs = [ctx.Process(target=target, args=(r, world, rendezvous,
                                              device_type, tmp_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"{len(hung)} of {world} ranks still ran after "
                           f"{deadline} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes}")
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
