"""Rowgroup data parallelism over the cards of a ``torch.distributed`` group.

Counterpart of ``alp_tpu/parallel/sharded.py``.  The JAX package lays a
column's vectors over a 1-D ``rg`` device mesh with ``shard_map`` and joins
the shards with ``psum``/``pmean``.  Here every rank is a process with one
device (NCCL on cards, gloo on the CPU), the caller starts the process
group, and every rank calls the same function with the same arguments:

* ``make_mesh``: the 1-D ``DeviceMesh`` (dim ``"rg"``) over the caller's
  process group;
* ``sharded_encode_decode_step``: each rank chooses each of its vectors'
  pair among the candidates (K11/K14), encodes them (K9/K12) and checks
  that they decode back; the per-vector results are gathered in vector
  order and the bits a value computed from them;
* ``sharded_decode`` (``sharded_falp_decode_f64`` and ``sharded_decode``
  of the JAX package in one): each rank decodes its share of every bucket
  (K1-K4 and the exception patch), an ordered gather joins them;
* ``sharded_filter_count``: K15's int64 bins of each share, all-reduced;
* ``sharded_exact_sum`` and ``sharded_groupby``: K5-K8's SUM totals and
  K19's per-group totals of each share.

A rank's share of a column is a run of whole rowgroups (``column_share``),
itself a column, so every path runs the single-card code on it.  The SUM
and GROUP-BY partials are gathered, never all-reduced: each row is the
total of fewer than 2^31 values, which is what keeps it inside int64
(``kernels/exact_sum.py``), and a sum of rows over ranks can wrap.  So every
rank gathers every rank's rows and joins them on the host exactly, as
one card joins its runs (``engine.join_totals`` in Python integers,
``engine._join_limbs`` in carried int64 limbs).  Ragged tensors travel as
bytes: their sizes first, then padded to the largest.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import constants as C
from .. import engine
from ..container import CompressedColumn
from ..kernels import exact_sum as kes
from ..kernels import group as kgroup
from ..device_compress import _second_level, finalize_encode_stats
from ..kernels.decode import _bits_dtype, build_plan
from ..kernels.encode import (alp_encode_f32, alp_encode_f64, decoded_bits,
                              decodes_to32, tables)
from ..ops.keys import bias

AXIS = "rg"
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
RG = C.N_VECTORS_PER_ROWGROUP


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


def gather_rows(mesh: DeviceMesh, t: torch.Tensor) -> list:
    """Every rank's ``t`` (on this rank's device, the same dtype and shape
    past dim 0 on every rank, dim 0 any length) in rank order: the byte
    counts first, then the bytes padded to the largest."""
    group = mesh.get_group(AXIS)
    dev = mesh_device(mesh)
    flat = t.to(dev).contiguous().reshape(-1).view(torch.uint8)
    size = torch.tensor([flat.numel()], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(size) for _ in range(mesh.size())]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s) for s in sizes]
    top = max(sizes)
    padded = torch.zeros(top, dtype=torch.uint8, device=dev)
    padded[:flat.numel()] = flat
    outs = [torch.empty(top, dtype=torch.uint8, device=dev)
            for _ in sizes]
    dist.all_gather(outs, padded, group=group)
    return [o[:n].view(t.dtype).reshape(-1, *t.shape[1:])
            for o, n in zip(outs, sizes)]


def column_share(col: CompressedColumn, mesh: DeviceMesh) -> tuple:
    """(the column of this rank's run of whole rowgroups, or None when the
    run is empty; (first value, one past its last value) in ``col``)."""
    lo, hi = share(col.n_rowgroups, mesh)
    v0, v1 = lo * RG, min(col.n_vectors, hi * RG)
    n0 = min(col.n_values, v0 * C.VECTOR_SIZE)
    n1 = min(col.n_values, v1 * C.VECTOR_SIZE)
    if v1 <= v0:
        return None, (n0, n1)
    vec = slice(v0, v1)
    return CompressedColumn(
        dtype=col.dtype, n_values=n1 - n0, n_vectors=v1 - v0,
        rg_scheme=col.rg_scheme[lo:hi], rd_dict=col.rd_dict[lo:hi],
        rd_dict_size=col.rd_dict_size[lo:hi],
        rd_left_bw=col.rd_left_bw[lo:hi], rd_right_bw=col.rd_right_bw[lo:hi],
        fac=col.fac[vec], exp=col.exp[vec], bit_width=col.bit_width[vec],
        base=col.base[vec], exc_count=col.exc_count[vec],
        packed=col.packed[vec], left_packed=col.left_packed[vec],
        exc_values=col.exc_values[vec], exc_positions=col.exc_positions[vec],
        enc_max=None if col.enc_max is None else col.enc_max[vec]), (n0, n1)


def _share_plan(col, mesh):
    """This rank's decode plan of its share (None when empty), and the
    share's value range.  The plan is built at the first call and kept on
    the column beside its single-device plans, as ``col.plan`` keeps
    those."""
    dev = mesh_device(mesh)
    key = ("share", mesh.size(), mesh.get_local_rank(AXIS), str(dev))
    if key not in col._plans:
        sub, at = column_share(col, mesh)
        col._plans[key] = (None if sub is None else build_plan(sub, dev)), at
    return col._plans[key]


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
# decode and queries over column shares
# ---------------------------------------------------------------------------

def sharded_decode(mesh: DeviceMesh, col: CompressedColumn) -> torch.Tensor:
    """The whole column's ``n_values`` values on this rank's device: each
    rank decodes its share (K1-K4 a bucket, then the exceptions), and an
    ordered gather joins the shares."""
    plan, (n0, n1) = _share_plan(col, mesh)
    vdt = torch.float64 if col.dtype == np.float64 else torch.float32
    local = (torch.empty(0, dtype=vdt, device=mesh_device(mesh))
             if plan is None else plan.run().reshape(-1)[:n1 - n0])
    return torch.cat(gather_rows(mesh, local))


def sharded_filter_count(mesh: DeviceMesh, col: CompressedColumn, lo: float,
                         hi: float) -> int:
    """COUNT WHERE lo <= v <= hi over the mesh (``engine.query_filter_count``
    of the whole column): K15's int64 bins of every share, all-reduced (a
    count stays below 2^63)."""
    if col.n_values == 0:
        return 0
    klo, khi = engine._float_key(lo, col.dtype), engine._float_key(hi,
                                                                  col.dtype)
    if klo > khi:
        return 0
    thr = np.array([khi] if klo == 0 else [klo - 1, khi],
                   dtype=engine._key_type(col.dtype))
    plan, _ = _share_plan(col, mesh)
    bins = (torch.zeros(len(thr) + 1, dtype=torch.int64,
                        device=mesh_device(mesh)) if plan is None
            else engine.key_count_bins(plan, thr))
    dist.all_reduce(bins, group=mesh.get_group(AXIS))
    return int(bins[len(thr) - 1])


def join_rank_totals(mesh: DeviceMesh, rows: torch.Tensor, dtype) -> tuple:
    """Every rank's int64 SUM totals ``rows`` [runs, W + 3] gathered and
    joined on the host as Python integers: (total_int, nan, pinf, ninf, B)
    of ``engine.join_totals``.  No row is added to another in int64."""
    parts = gather_rows(mesh, rows)
    return engine.join_totals([r for p in parts for r in p.cpu().tolist()],
                              dtype)


def sharded_exact_sum(mesh: DeviceMesh, col: CompressedColumn) -> float:
    """SUM(column) over the mesh, bit-identical to ``math.fsum`` and
    ``engine.query_sum``: each share's K5-K8 totals
    (``engine.exact_sum_totals``), joined by :func:`join_rank_totals`."""
    if col.n_values == 0:
        return 0.0
    plan, _ = _share_plan(col, mesh)
    W = kes.WINDOWS[_bits_dtype(col.dtype)]
    rows = (torch.zeros((1, W + 3), dtype=torch.int64,
                        device=mesh_device(mesh)) if plan is None
            else engine.exact_sum_totals(plan))
    return engine._finish_sum(*join_rank_totals(mesh, rows, col.dtype))


def sharded_groupby(mesh: DeviceMesh, col: CompressedColumn, keys,
                    num_groups: int,
                    aggs=("sum", "count", "min", "max", "mean")) -> dict:
    """GROUP-BY over the mesh, the answer of ``engine.query_groupby`` by
    bits: each share's K19 runs ([G, W + 4] int64 a run) and keys, gathered;
    the runs joined exactly on the host (``engine._join_limbs``), the keys
    merged in the total order."""
    keys = engine._checked_keys(col, keys, num_groups)
    if col.n_values == 0:
        return engine._empty_groups(num_groups, aggs, col.dtype)
    plan, (n0, n1) = _share_plan(col, mesh)
    if plan is None:                 # no run: [0, G, W + 4], empty keys
        out, ext = kgroup.group_outputs(num_groups, _bits_dtype(col.dtype),
                                        mesh_device(mesh))
        runs = out[None][:0]
    else:
        outs, ext = engine.group_reduce(
            plan, engine._unordered_keys(plan, keys[n0:n1]), num_groups)
        runs = torch.stack(outs)
    parts = [r for p in gather_rows(mesh, runs) for r in p]
    exts = bias(torch.stack(gather_rows(mesh, ext)))
    merged = bias(torch.stack([exts[:, :, 0].amin(0), exts[:, :, 1].amax(0)],
                              dim=1))
    return engine._finish_groups(
        engine._unordered_host(col.dtype, parts, merged), aggs, col.dtype)
