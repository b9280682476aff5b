"""Rowgroup data parallelism over the cards of a ``torch.distributed`` group.

Counterpart of ``alp_tpu/parallel/sharded.py``.  The JAX package lays a
column's vectors over a 1-D ``rg`` device mesh with ``shard_map`` and joins
the shards with ``psum``/``pmean``.  Here every rank is a process with one
device (NCCL on cards, gloo on the CPU), the caller starts the process
group, and every rank calls the same function at the same point:

* ``make_mesh``: the 1-D ``DeviceMesh`` (dim ``"rg"``) over the caller's
  process group;
* ``sharded_encode_decode_step``: each rank chooses each of its vectors'
  pair among the candidates (K11/K14), encodes them (K9/K12) and checks
  that they decode back; the per-vector results are gathered in vector
  order and the bits a value computed from them;
* :class:`ColumnShare`: a rank's share of a column, a run of whole
  rowgroups: its own ``CompressedColumn`` of them, the index of its first
  row and the whole column's length, checked once over the mesh when it
  is made.  A rank that holds only its own rowgroups makes its share
  itself; ``column_share`` cuts it out of a whole column that every rank
  holds, and keeps it on that column.

Every query has one body, which takes a share and runs the single-card
code on the share's column (its plan is ``col.plan(device)``):

* ``share_decode`` (``sharded_falp_decode_f64`` and ``sharded_decode`` of
  the JAX package in one): each rank decodes its share of every bucket
  (K1-K4 and the exception patch), an ordered gather joins them;
* ``share_filter_count``: K15's int64 bins of each share, all-reduced;
* ``share_sum``, ``share_mean`` and ``share_filter_sum``: K5-K8's SUM
  totals of each share (with the key range of SUM WHERE), gathered and
  joined, then rounded once as ``engine.query_sum``, ``query_mean`` and
  ``query_filter_sum`` round them;
* ``share_groupby``: K19's per-group totals of each share, gathered.

The whole-column entry points ``sharded_decode``, ``sharded_filter_count``,
``sharded_exact_sum`` and ``sharded_groupby`` cut the share
(``column_share``) and call the body.

The SUM and GROUP-BY partials are gathered, never all-reduced: each row
is the total of fewer than 2^31 values, which is what keeps it inside
int64 (``kernels/exact_sum.py``), and a sum of rows over ranks can wrap.
So every rank gathers every rank's rows and joins them on the host
exactly, as one card joins its runs (``engine.join_totals`` in Python
integers, ``engine._join_limbs`` in carried int64 limbs).  Ragged tensors
travel as bytes: their sizes first, then padded to the largest.

Spans and counters (``tracing``): ``alp.parallel.<query>`` around each
body (``decode``, ``filter_count``, ``sum``, ``mean``, ``filter_sum``,
``groupby``) and ``alp.parallel.share`` around a share's check;
``alp.parallel.all_gather`` and ``alp.parallel.all_reduce`` around each
collective; ``alp.parallel.join`` around the host's exact join of the SUM
rows; ``alp.fetch.parallel.<site>`` around each wait on the device:
``sizes`` (a gather's byte counts), ``rows`` (the gathered SUM rows),
``count`` (the all-reduced count), ``share`` (a share's check).  The
counters ``alp.parallel.collectives`` and ``alp.parallel.bytes`` count the
collectives and their payload: an all-gather's gathered bytes, an
all-reduce's reduced bytes.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import constants as C
from .. import engine, tracing
from ..container import CompressedColumn
from ..kernels import exact_sum as kes
from ..kernels import group as kgroup
from ..device_compress import _second_level, finalize_encode_stats
from ..kernels.decode import _bits_dtype
from ..kernels.encode import (alp_encode_f32, alp_encode_f64, decoded_bits,
                              decodes_to32, tables)
from ..ops.keys import bias

AXIS = "rg"
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
RG = C.N_VECTORS_PER_ROWGROUP
RG_ROWS = RG * C.VECTOR_SIZE
_DTYPE_CODE = {np.dtype(np.float64): 0, np.dtype(np.float32): 1}


def make_mesh(n_devices: int | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """The 1-D mesh (dim ``"rg"``) over every rank of the process group the
    caller started (``torch.distributed.init_process_group``, one rank a
    device: ``"nccl"`` for ``device_type="cuda"``, ``"gloo"`` for
    ``"cpu"``).  ``n_devices``, when given, must be the world size.  Raises
    instead of choosing another backend or device."""
    if device_type not in _BACKEND:
        raise ValueError(f"device_type is 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh spans the whole group: n_devices "
                         f"{n_devices}, world size {world}")
    backend = dist.get_backend()
    if backend != _BACKEND[device_type]:
        raise RuntimeError(f"a {device_type} mesh needs the "
                           f"{_BACKEND[device_type]} backend, the process "
                           f"group has {backend}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; start a gloo "
                           "group and pass device_type='cpu'")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(AXIS,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def share(n: int, mesh: DeviceMesh) -> tuple:
    """(lo, hi): the run of ``n`` items that this rank takes, contiguous
    and in rank order; sizes differ by one at most."""
    size, r = mesh.size(), mesh.get_local_rank(AXIS)
    return n * r // size, n * (r + 1) // size


def _moved(n_bytes: int) -> None:
    tracing.count("alp.parallel.collectives")
    tracing.count("alp.parallel.bytes", n_bytes)


def _all_gather(outs: list, t: torch.Tensor, group) -> None:
    with tracing.span("alp.parallel.all_gather"):
        dist.all_gather(outs, t, group=group)
    _moved(sum(o.numel() * o.element_size() for o in outs))


def _all_reduce(t: torch.Tensor, group) -> None:
    with tracing.span("alp.parallel.all_reduce"):
        dist.all_reduce(t, group=group)
    _moved(t.numel() * t.element_size())


def gather_rows(mesh: DeviceMesh, t: torch.Tensor) -> list:
    """Every rank's ``t`` (on this rank's device, the same dtype and shape
    past dim 0 on every rank, dim 0 any length) in rank order: the byte
    counts first, then the bytes padded to the largest."""
    group = mesh.get_group(AXIS)
    dev = mesh_device(mesh)
    flat = t.to(dev).contiguous().reshape(-1).view(torch.uint8)
    size = torch.full((1,), flat.numel(), dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(size) for _ in range(mesh.size())]
    _all_gather(sizes, size, group)
    with tracing.span("alp.fetch.parallel.sizes"):
        sizes = torch.cat(sizes).tolist()
    top = max(sizes)
    padded = torch.zeros(top, dtype=torch.uint8, device=dev)
    padded[:flat.numel()] = flat
    outs = [torch.empty(top, dtype=torch.uint8, device=dev)
            for _ in sizes]
    _all_gather(outs, padded, group)
    return [o[:n].view(t.dtype).reshape(-1, *t.shape[1:])
            for o, n in zip(outs, sizes)]


class ColumnShare:
    """This rank's share of a column on ``mesh``: ``col``, the rank's own
    ``CompressedColumn`` of a run of whole rowgroups (None where the run is
    empty, with the column's ``dtype`` given), ``start``, the index of its
    first row in the whole column, and ``n_total``, the whole column's
    length.

    Making one is collective: every rank of the mesh makes its share at
    the same point, and one all-gather of each rank's (start, length,
    n_total, dtype) checks that every share starts on a rowgroup boundary,
    that the shares tile [0, n_total) in rank order as :func:`share` splits
    the rowgroups (no gap, no overlap), and that every rank has the same
    ``n_total`` and dtype.  Otherwise every rank raises the same
    ``ValueError``, so no query ever answers over a gap or an overlap.
    Keep the share and query it again; its plan is ``col.plan(device)``,
    kept on the column."""

    def __init__(self, col: CompressedColumn | None, start: int,
                 n_total: int, mesh: DeviceMesh, dtype=None):
        if col is None and dtype is None:
            raise ValueError("an empty share needs the column's dtype")
        self.col = col
        self.start, self.n_total = int(start), int(n_total)
        self.mesh = mesh
        self.dtype = np.dtype(col.dtype if col is not None else dtype)
        self.n_values = 0 if col is None else int(col.n_values)
        with tracing.span("alp.parallel.share"):
            self._check()

    @property
    def empty(self) -> bool:
        return self.n_values == 0

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)

    @property
    def plan(self):
        """The decode plan of the share's column on this rank's device
        (None for an empty share)."""
        return None if self.empty else self.col.plan(self.device)

    def _check(self) -> None:
        dev = self.device
        mine = [self.start, self.n_values, self.n_total,
                _DTYPE_CODE.get(self.dtype, -1)]
        with tracing.span("alp.fetch.parallel.share"):
            t = torch.tensor(mine, dtype=torch.int64).to(dev)
        outs = [torch.empty_like(t) for _ in range(self.mesh.size())]
        _all_gather(outs, t, self.mesh.get_group(AXIS))
        with tracing.span("alp.fetch.parallel.share"):
            got = torch.stack(outs).tolist()
        _check_tiling(got)


def _check_tiling(got: list) -> None:
    """Raise ``ValueError`` unless the shares ``got`` ([start, length,
    n_total, dtype code] of each rank, in rank order) tile [0, n_total) as
    :func:`share` splits the rowgroups, on one length and dtype."""
    n_total, code = got[0][2], got[0][3]
    if any(g[2] != n_total or g[3] != code for g in got):
        raise ValueError(f"the ranks' shares disagree on the column's "
                         f"length or dtype: {[g[2:] for g in got]}")
    if code < 0:
        raise ValueError("a share is of a float64 or float32 column")
    at = 0
    for r, (start, n, _, _) in enumerate(got):
        if start % RG_ROWS:
            raise ValueError(f"rank {r}'s share starts at row {start}, off "
                             f"a rowgroup boundary ({RG_ROWS} rows)")
        if start < at:
            raise ValueError(f"rank {r}'s share starts at row {start}, "
                             f"inside the shares before it (which end at "
                             f"{at}): the shares overlap")
        if start > at:
            raise ValueError(f"rows [{at}, {start}) lie in no share: a gap "
                             f"before rank {r}'s")
        at = start + n
    groups, world = -(-n_total // RG_ROWS), len(got)
    for r, (start, n, _, _) in enumerate(got):
        want = (min(n_total, groups * r // world * RG_ROWS),
                min(n_total, groups * (r + 1) // world * RG_ROWS))
        if (start, start + n) != want:
            raise ValueError(f"rank {r}'s share is rows [{start}, "
                             f"{start + n}); the split of the rowgroups "
                             f"gives rows [{want[0]}, {want[1]})")


def column_share(col: CompressedColumn, mesh: DeviceMesh) -> ColumnShare:
    """This rank's share of a whole column that every rank holds: its run
    of whole rowgroups (:func:`share` of the rowgroups) as a column of its
    own, kept on ``col`` for the mesh, so that its check runs and its plan
    is built once."""
    key = ("share", mesh.size(), mesh.get_local_rank(AXIS))
    got = col._plans.get(key)
    if got is not None and got.mesh is mesh:
        return got
    lo, hi = share(col.n_rowgroups, mesh)
    v0, v1 = lo * RG, min(col.n_vectors, hi * RG)
    n0 = min(col.n_values, v0 * C.VECTOR_SIZE)
    n1 = min(col.n_values, v1 * C.VECTOR_SIZE)
    sub = None
    if n1 > n0:
        vec = slice(v0, v1)
        sub = CompressedColumn(
            dtype=col.dtype, n_values=n1 - n0, n_vectors=v1 - v0,
            rg_scheme=col.rg_scheme[lo:hi], rd_dict=col.rd_dict[lo:hi],
            rd_dict_size=col.rd_dict_size[lo:hi],
            rd_left_bw=col.rd_left_bw[lo:hi],
            rd_right_bw=col.rd_right_bw[lo:hi],
            fac=col.fac[vec], exp=col.exp[vec],
            bit_width=col.bit_width[vec], base=col.base[vec],
            exc_count=col.exc_count[vec], packed=col.packed[vec],
            left_packed=col.left_packed[vec],
            exc_values=col.exc_values[vec],
            exc_positions=col.exc_positions[vec],
            enc_max=None if col.enc_max is None else col.enc_max[vec])
    got = col._plans[key] = ColumnShare(sub, n0, col.n_values, mesh,
                                        col.dtype)
    return got


# ---------------------------------------------------------------------------
# encode step
# ---------------------------------------------------------------------------

def sharded_encode_decode_step(mesh: DeviceMesh, dtype):
    """The encode step over the mesh: ``step(values, combos, k_count)``
    with the whole inputs on every rank (numpy or tensors: values [n, 1024]
    of ``dtype``, combos int32 [n, 5, 2] (e, f), k_count int32 [n], the
    number of real candidates).  Each rank takes a run of the vectors,
    chooses each one's pair (the first candidate, or K11/K14's scores of
    the candidates and the accept scan where k_count > 1), encodes it with
    K9/K12 and decodes the integers back.  Returns, on every rank, numpy
    arrays [n] in vector order: ``fac``, ``exp``, ``bit_width``, ``base``
    (of the integers' width), ``exc_count``, ``ok`` (every value decodes
    back or is an exception), and ``global_bits_per_value``, the column's
    mean of bit width plus exception cost a value (from the gathered
    integers, divided once)."""
    f64 = np.dtype(dtype) == np.float64
    tc = C.DOUBLE if f64 else C.FLOAT
    vdt = torch.float64 if f64 else torch.float32
    encode = alp_encode_f64 if f64 else alp_encode_f32

    def step(values, combos, k_count) -> dict:
        dev = mesh_device(mesh)
        n = values.shape[0]
        lo, hi = share(n, mesh)
        v = torch.as_tensor(values[lo:hi]).to(dev, vdt).contiguous()
        cb = torch.as_tensor(combos[lo:hi]).to(dev, torch.int32)
        kc = torch.as_tensor(k_count[lo:hi]).to(dev, torch.int32)
        cols = torch.zeros((0, 6), dtype=torch.int64, device=dev)
        if hi > lo:
            fac, exp = _second_level(v[:, ::C.VECTOR_SIZE
                                       // C.SAMPLES_PER_VECTOR].contiguous(),
                                     cb, kc, bool((kc > 1).any()))
            ints, exc, *stats = encode(v, exp, fac, stats=True)
            bw, base, _, n_exc, _ = finalize_encode_stats(ints, *stats)
            t = tables(dev, tc)
            e, f = exp.to(torch.int64)[:, None], fac.to(torch.int64)[:, None]
            if f64:
                back = decoded_bits(ints, t.fact[f], t.frac[e]) == \
                    v.view(torch.int64)
            else:
                back = decodes_to32(ints, e, f, v, t)
            ok = (back | exc).all(dim=1)
            cols = torch.stack([fac.to(torch.int64), exp.to(torch.int64),
                                bw.to(torch.int64), base.to(torch.int64),
                                n_exc.to(torch.int64),
                                ok.to(torch.int64)], dim=1)
        got = torch.cat(gather_rows(mesh, cols)).cpu().numpy()
        exc_bits = tc.exception_size + C.EXCEPTION_POSITION_SIZE
        bits = Fraction(int(got[:, 2].sum()) * C.VECTOR_SIZE
                        + int(got[:, 4].sum()) * exc_bits,
                        C.VECTOR_SIZE * max(n, 1))
        return {"fac": got[:, 0], "exp": got[:, 1], "bit_width": got[:, 2],
                "base": got[:, 3].astype(tc.st), "exc_count": got[:, 4],
                "ok": got[:, 5].astype(bool),
                "global_bits_per_value": float(bits)}

    return step


# ---------------------------------------------------------------------------
# decode and queries, one body each over a share
# ---------------------------------------------------------------------------

@tracing.spanned("alp.parallel.decode")
def share_decode(sh: ColumnShare) -> torch.Tensor:
    """The whole column's ``n_total`` values on this rank's device: each
    rank decodes its share (K1-K4 a bucket, then the exceptions), and an
    ordered gather joins the shares."""
    vdt = torch.float64 if sh.dtype == np.float64 else torch.float32
    local = (torch.empty(0, dtype=vdt, device=sh.device) if sh.empty
             else sh.plan.run().reshape(-1)[:sh.n_values])
    return torch.cat(gather_rows(sh.mesh, local))


def _key_bounds(sh: ColumnShare, lo: float, hi: float) -> tuple:
    """The unsigned keys of ``lo`` and ``hi`` rounded to the column's
    dtype (``engine._float_key``)."""
    return engine._float_key(lo, sh.dtype), engine._float_key(hi, sh.dtype)


@tracing.spanned("alp.parallel.filter_count")
def share_filter_count(sh: ColumnShare, lo: float, hi: float) -> int:
    """COUNT WHERE lo <= v <= hi over the mesh (``engine.query_filter_count``
    of the whole column): K15's int64 bins of every share, all-reduced (a
    count stays below 2^63)."""
    if sh.n_total == 0:
        return 0
    klo, khi = _key_bounds(sh, lo, hi)
    if klo > khi:
        return 0
    thr = np.array([khi] if klo == 0 else [klo - 1, khi],
                   dtype=engine._key_type(sh.dtype))
    bins = (torch.zeros(len(thr) + 1, dtype=torch.int64, device=sh.device)
            if sh.empty else engine.key_count_bins(sh.plan, thr))
    _all_reduce(bins, sh.mesh.get_group(AXIS))
    with tracing.span("alp.fetch.parallel.count"):
        return int(bins[len(thr) - 1])


def _joined(mesh: DeviceMesh, rows: torch.Tensor, dtype, finish):
    """``finish(total_int, nan, pinf, ninf, B)`` of every rank's int64 SUM
    totals ``rows`` [runs, W + 3], gathered and joined on the host as
    Python integers (``engine.join_totals``).  No row is added to another
    in int64."""
    parts = gather_rows(mesh, rows)
    with tracing.span("alp.fetch.parallel.rows"):
        host = torch.cat(parts).cpu().tolist()
    with tracing.span("alp.parallel.join"):
        return finish(*engine.join_totals(host, dtype))


def join_rank_totals(mesh: DeviceMesh, rows: torch.Tensor, dtype) -> tuple:
    """Every rank's int64 SUM totals ``rows`` [runs, W + 3] gathered and
    joined on the host as Python integers: (total_int, nan, pinf, ninf, B)
    of ``engine.join_totals``."""
    return _joined(mesh, rows, dtype, lambda *joined: joined)


def join_mean(mesh: DeviceMesh, rows: torch.Tensor, dtype,
              n_total: int) -> float:
    """The exact sum of every rank's ``rows`` over ``n_total``, rounded
    once (``query_mean``)."""
    return _joined(mesh, rows, dtype,
                   lambda *joined: engine._finish_mean(*joined, n_total))


def join_filter_sum(mesh: DeviceMesh, rows: torch.Tensor, dtype):
    """The SUM of every rank's filtered ``rows``, rounded once and given as
    the column dtype's scalar (``query_filter_sum``)."""
    return _joined(mesh, rows, dtype, lambda *joined: np.dtype(dtype).type(
        engine._finish_sum(*joined)))


def _sum_rows(sh: ColumnShare, key_range=None) -> torch.Tensor:
    """The share's K5-K8 totals (``engine.exact_sum_totals``), a row of
    zeros for an empty share."""
    if sh.empty:
        W = kes.WINDOWS[_bits_dtype(sh.dtype)]
        return torch.zeros((1, W + 3), dtype=torch.int64, device=sh.device)
    return engine.exact_sum_totals(sh.plan, key_range=key_range)


@tracing.spanned("alp.parallel.sum")
def share_sum(sh: ColumnShare) -> float:
    """SUM(column) over the mesh, bit-identical to ``math.fsum`` and
    ``engine.query_sum``: each share's K5-K8 totals, gathered, joined and
    rounded once."""
    if sh.n_total == 0:
        return 0.0
    return _joined(sh.mesh, _sum_rows(sh), sh.dtype, engine._finish_sum)


@tracing.spanned("alp.parallel.mean")
def share_mean(sh: ColumnShare) -> float:
    """MEAN(column) over the mesh, ``engine.query_mean``'s answer by bits:
    the exact sum of every share's totals over ``n_total``, rounded once
    (:func:`join_mean`).  An empty column gives NaN."""
    if sh.n_total == 0:
        return float("nan")
    return join_mean(sh.mesh, _sum_rows(sh), sh.dtype, sh.n_total)


@tracing.spanned("alp.parallel.filter_sum")
def share_filter_sum(sh: ColumnShare, lo: float, hi: float):
    """SUM(v) WHERE lo <= v <= hi over the mesh, ``engine.query_filter_sum``'s
    answer by bits (the column dtype's scalar; 0.0 for an empty column or
    selection): each share's K5-K8 totals over the key range, gathered and
    joined (:func:`join_filter_sum`)."""
    if sh.n_total == 0:
        return 0.0
    klo, khi = _key_bounds(sh, lo, hi)
    if klo > khi:
        return 0.0
    return join_filter_sum(sh.mesh, _sum_rows(sh, (klo, khi)), sh.dtype)


@tracing.spanned("alp.parallel.groupby")
def share_groupby(sh: ColumnShare, keys, num_groups: int,
                  aggs=("sum", "count", "min", "max", "mean")) -> dict:
    """GROUP-BY over the mesh, the answer of ``engine.query_groupby`` on the
    whole column by bits: ``keys`` are the group ids of the share's own
    rows (each rank checks its own, so pass keys that every rank's check
    accepts); each share's K19 runs ([G, W + 4] int64 a run) and keys,
    gathered; the runs joined exactly on the host (``engine._join_limbs``),
    the keys merged in the total order."""
    keys = engine._checked_keys(sh, keys, num_groups)
    if sh.n_total == 0:
        return engine._empty_groups(num_groups, aggs, sh.dtype)
    if sh.empty:                     # no run: [0, G, W + 4], empty keys
        out, ext = kgroup.group_outputs(num_groups, _bits_dtype(sh.dtype),
                                        sh.device)
        runs = out[None][:0]
    else:
        plan = sh.plan
        outs, ext = engine.group_reduce(
            plan, engine._unordered_keys(plan, keys), num_groups)
        runs = torch.stack(outs)
    parts = [r for p in gather_rows(sh.mesh, runs) for r in p]
    exts = bias(torch.stack(gather_rows(sh.mesh, ext)))
    merged = bias(torch.stack([exts[:, :, 0].amin(0), exts[:, :, 1].amax(0)],
                              dim=1))
    return engine._finish_groups(
        engine._unordered_host(sh.dtype, parts, merged), aggs, sh.dtype)


# ---------------------------------------------------------------------------
# the same queries on a whole column that every rank holds
# ---------------------------------------------------------------------------

def sharded_decode(mesh: DeviceMesh, col: CompressedColumn) -> torch.Tensor:
    """:func:`share_decode` of this rank's share of ``col``."""
    return share_decode(column_share(col, mesh))


def sharded_filter_count(mesh: DeviceMesh, col: CompressedColumn, lo: float,
                         hi: float) -> int:
    """:func:`share_filter_count` of this rank's share of ``col``."""
    return share_filter_count(column_share(col, mesh), lo, hi)


def sharded_exact_sum(mesh: DeviceMesh, col: CompressedColumn) -> float:
    """:func:`share_sum` of this rank's share of ``col``."""
    return share_sum(column_share(col, mesh))


def sharded_groupby(mesh: DeviceMesh, col: CompressedColumn, keys,
                    num_groups: int,
                    aggs=("sum", "count", "min", "max", "mean")) -> dict:
    """:func:`share_groupby` of this rank's share of ``col``, ``keys`` the
    whole column's (checked whole on every rank)."""
    keys = engine._checked_keys(col, keys, num_groups)
    sh = column_share(col, mesh)
    return share_groupby(sh, keys[sh.start:sh.start + sh.n_values],
                         num_groups, aggs)
