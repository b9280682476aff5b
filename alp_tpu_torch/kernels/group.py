"""The port's grouped kernels: wrappers, plain PyTorch versions, counts.

Both decode one bucket of a plan (K1-K4's arguments), write each vector's
true exception bits in from the plan's per-vector CSR and skip the pad of
a partial last vector, as the key kernels do (``kernels.keys``); then they
add every value's signed digits in the exact-SUM window layout of
``kernels.exact_sum`` (W windows, W = 66 for f64 and 9 for f32, then the
NaN, +Inf and -Inf counts) and take its IEEE-754 total-order key
(``ops.keys``):

    K18 vector_sum_extremes  <- alp_tpu/kernels/falp.py sum_extremes_planes_f64
    K19 group_reduce         no TPU site: the XLA grouped passes of
                             alp_tpu/engine.py (_mxu_scan, the segment_sum
                             chunks _groupby_chunk_f64/_f32)

and, over decoded f64 bits rather than the compressed form, for the
bench's rows:

    K23 key_extremes_bits    <- key_extremes_planes_f64: each vector's
                                least and largest key, every value read

K18 writes row ``rows[i]`` of ``sums`` (int64 [N, W + 3], the totals of
vector rows[i]) and of ``keys`` ([N, 2] in the bit patterns' dtype, its
least and largest unsigned key).  K19 reads ``group_keys`` (int32 [n,
1024], the group id of every value of bucket row i, aligned with the
bucket's rows), adds into ``out`` (int64 [G, W + 4]: each group's windows,
special counts and row count) and merges into ``ext`` ([G, 2] keys: the
least and largest key of each group, from ``group_outputs`` at (all ones,
0), which a group that no value reaches keeps).  A group id outside [0,
G) is not counted (``engine`` checks the keys first); 1 <= G <= 2^24.  One
K19 call sums fewer than 2^31 values, so no int64 window can overflow; a
K18 row holds one vector, so K18 takes a bucket of any size.

Each scheme has one wrapper a kernel (``*_alp``: K1/K2's ``packed, bw,
base, fact, frac`` and the ALP exceptions' true bits; ``*_rd``: K3/K4's
``right, rbw, left, lbw, dictionary, dict_size`` and the ALP_RD
exceptions' raw left parts); the words' dtype picks f64 or f32.  A CUDA
tensor goes through the hand-written kernel in ``csrc/group.cu`` on the
current stream of the tensors' card, without a synchronise; a CPU tensor
goes through the plain version beside it.  Totals, counts and keys are
integers: the kernels equal their plain versions exactly.  ``LAUNCHES``
counts kernel launches per kernel; plain runs do not count.  The bound of
each, and what its design does about it, are in the head of
``csrc/group.cu``.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..ops.keys import bias, biased_keys
from .exact_sum import WINDOWS, _check_size, digit_rows, falp_bits_plain
from .falp import VECTOR_SIZE, _check, _device_kind, _launch, _ptr
from .keys import _WORDS, _check_alp, _check_rd, _valid, extremes_of_bits
from .keys import rd_bits_plain

MAX_GROUPS = 1 << 24            # csrc/group.cu kMaxGroups: 24-bit group ids
LAUNCHES = tracing.Counters("alp.launch.", (
    "vector_sum_extremes", "group_reduce", "key_extremes_bits"))


reset_launches = LAUNCHES.reset


def group_outputs(num_groups: int, dtype, device) -> tuple:
    """K19's zeroed ``out`` (int64 [G, W + 4]) and ``ext`` ([G, 2] keys in
    the bit patterns' ``dtype``, each pair at (all ones, 0))."""
    out = torch.zeros((num_groups, WINDOWS[dtype] + 4), dtype=torch.int64,
                      device=device)
    ext = torch.zeros((num_groups, 2), dtype=dtype, device=device)
    ext[:, 0] = -1
    return out, ext


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def sums_of_bits(bits, rows, n_values) -> tuple:
    """Plain K18 over decoded bits [n, 1024]: (int64 [n, W + 3] totals,
    [n, 2] (least, largest) unsigned keys) of each row's values that are
    not pad."""
    valid = _valid(rows, n_values)
    at = torch.arange(bits.shape[0], device=bits.device)[:, None]
    sums = digit_rows(bits[valid], at.expand_as(bits)[valid],
                      bits.shape[0])
    return sums, extremes_of_bits(bits, rows, n_values)


def groups_of_bits(bits, rows, n_values, group_keys, num_groups) -> tuple:
    """Plain K19 over decoded bits [n, 1024] and their group ids: (int64
    [G, W + 4] windows, special counts and row counts, [G, 2] least and
    largest unsigned keys, (all ones, 0) for a group without a value)."""
    g = group_keys.to(torch.int64)
    keep = _valid(rows, n_values) & (g >= 0) & (g < num_groups)
    b, g = bits[keep], g[keep]
    out = torch.cat([digit_rows(b, g, num_groups),
                     torch.bincount(g, minlength=num_groups)[:, None]], 1)
    keys = biased_keys(b)
    info = torch.iinfo(keys.dtype)
    lo = torch.full((num_groups,), info.max, dtype=keys.dtype,
                    device=keys.device)
    hi = torch.full_like(lo, info.min)
    lo.scatter_reduce_(0, g, keys, "amin")
    hi.scatter_reduce_(0, g, keys, "amax")
    return out, bias(torch.stack([lo, hi], dim=1))


def vector_sums_alp_plain(packed, bw, base, fact, frac, rows, exc_ptr,
                          exc_index, exc_bits, n_values):
    return sums_of_bits(falp_bits_plain(packed, bw, base, fact, frac, rows,
                                        exc_ptr, exc_index, exc_bits),
                        rows, n_values)


def vector_sums_rd_plain(right, rbw, left, lbw, dictionary, dict_size, rows,
                         exc_ptr, exc_index, exc_left, n_values):
    return sums_of_bits(rd_bits_plain(right, rbw, left, lbw, dictionary,
                                      dict_size, rows, exc_ptr, exc_index,
                                      exc_left), rows, n_values)


def group_reduce_alp_plain(packed, bw, base, fact, frac, rows, exc_ptr,
                           exc_index, exc_bits, n_values, group_keys,
                           num_groups):
    return groups_of_bits(falp_bits_plain(packed, bw, base, fact, frac, rows,
                                          exc_ptr, exc_index, exc_bits),
                          rows, n_values, group_keys, num_groups)


def group_reduce_rd_plain(right, rbw, left, lbw, dictionary, dict_size,
                          rows, exc_ptr, exc_index, exc_left, n_values,
                          group_keys, num_groups):
    return groups_of_bits(rd_bits_plain(right, rbw, left, lbw, dictionary,
                                        dict_size, rows, exc_ptr, exc_index,
                                        exc_left),
                          rows, n_values, group_keys, num_groups)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_PLAIN = {"alp": (_check_alp, vector_sums_alp_plain, group_reduce_alp_plain),
          "rd": (_check_rd, vector_sums_rd_plain, group_reduce_rd_plain)}


def _vector_sums(scheme, args, n_values, sums, keys):
    """K18 over one bucket into rows ``rows`` of ``sums`` and ``keys``."""
    check, plain, _ = _PLAIN[scheme]
    wtype, n, device = check(*args, n_values)
    W = WINDOWS[wtype]
    if sums.dim() != 2 or sums.shape[1] != W + 3:
        raise ValueError(f"sums must be [N, {W + 3}]")
    _check("sums", sums, torch.int64, sums.shape, device)
    _check("keys", keys, wtype, (sums.shape[0], 2), device)
    rows = args[5] if scheme == "alp" else args[6]
    if _device_kind(rows) == "cpu":
        sums[rows], keys[rows] = plain(*args, n_values)
        return sums, keys
    entry = f"vector_sums_{scheme}_{_WORDS[wtype][0]}"
    ptrs = [a if isinstance(a, int) else _ptr(a) for a in args]
    _launch(entry, device, *ptrs, n, n_values, _ptr(sums), _ptr(keys),
            device.index)
    LAUNCHES["vector_sum_extremes"] += 1
    return sums, keys


def _group_reduce(scheme, args, n_values, group_keys, num_groups, out, ext):
    """K19 over one bucket, added into ``out`` and merged into ``ext``."""
    check, _, plain = _PLAIN[scheme]
    wtype, n, device = check(*args, n_values)
    _check_size(n, n_values)
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"num_groups {num_groups} out of 1..2^24")
    _check("group_keys", group_keys, torch.int32, (n, VECTOR_SIZE), device)
    _check("out", out, torch.int64, (num_groups, WINDOWS[wtype] + 4), device)
    _check("ext", ext, wtype, (num_groups, 2), device)
    if _device_kind(group_keys) == "cpu":
        got, got_ext = plain(*args, n_values, group_keys, num_groups)
        out += got
        a, b = bias(ext), bias(got_ext)
        ext.copy_(bias(torch.stack([torch.minimum(a[:, 0], b[:, 0]),
                                    torch.maximum(a[:, 1], b[:, 1])], 1)))
        return out, ext
    entry = f"group_reduce_{scheme}_{_WORDS[wtype][0]}"
    ptrs = [a if isinstance(a, int) else _ptr(a) for a in args]
    _launch(entry, device, *ptrs, n, n_values, _ptr(group_keys), num_groups,
            _ptr(out), _ptr(ext), device.index)
    LAUNCHES["group_reduce"] += 1
    return out, ext


@tracing.kernel
def vector_sums_alp(packed, bw, base, fact, frac, rows, exc_ptr, exc_index,
                    exc_bits, n_values, sums, keys):
    """K18 on an ALP bucket.  K15's arguments (``kernels.keys``) up to
    ``n_values``; writes the totals of vector rows[i] into ``sums[rows[i]]``
    (int64 [N, W + 3]) and its (least, largest) key into ``keys[rows[i]]``
    ([N, 2] in the words' dtype)."""
    return _vector_sums("alp", (packed, bw, base, fact, frac, rows, exc_ptr,
                                exc_index, exc_bits), n_values, sums, keys)


@tracing.kernel
def vector_sums_rd(right, rbw, left, lbw, dictionary, dict_size, rows,
                   exc_ptr, exc_index, exc_left, n_values, sums, keys):
    """K18 on an ALP_RD bucket, as :func:`vector_sums_alp`."""
    return _vector_sums("rd", (right, rbw, left, lbw, dictionary, dict_size,
                               rows, exc_ptr, exc_index, exc_left), n_values,
                        sums, keys)


@tracing.kernel
def group_reduce_alp(packed, bw, base, fact, frac, rows, exc_ptr, exc_index,
                     exc_bits, n_values, group_keys, num_groups, out, ext):
    """K19 on an ALP bucket: K15's arguments up to ``n_values``, then the
    int32 [n, 1024] group id of every value of the bucket's rows and G;
    adds into ``out`` (int64 [G, W + 4]) and merges into ``ext`` ([G, 2]
    keys), both from ``group_outputs``."""
    return _group_reduce("alp", (packed, bw, base, fact, frac, rows, exc_ptr,
                                 exc_index, exc_bits), n_values, group_keys,
                         num_groups, out, ext)


@tracing.kernel
def group_reduce_rd(right, rbw, left, lbw, dictionary, dict_size, rows,
                    exc_ptr, exc_index, exc_left, n_values, group_keys,
                    num_groups, out, ext):
    """K19 on an ALP_RD bucket, as :func:`group_reduce_alp`."""
    return _group_reduce("rd", (right, rbw, left, lbw, dictionary, dict_size,
                                rows, exc_ptr, exc_index, exc_left), n_values,
                         group_keys, num_groups, out, ext)


# scheme -> kernel -> (wrapper, plain version); the plain versions take the
# wrappers' positional arguments without the outputs and return K18's
# ([n, W + 3] totals, [n, 2] keys) of the bucket's rows or K19's ([G, W + 4]
# totals and counts, [G, 2] keys) of the bucket
KERNELS = {
    "alp": {"vector_sum_extremes": (vector_sums_alp, vector_sums_alp_plain),
            "group_reduce": (group_reduce_alp, group_reduce_alp_plain)},
    "rd": {"vector_sum_extremes": (vector_sums_rd, vector_sums_rd_plain),
           "group_reduce": (group_reduce_rd, group_reduce_rd_plain)},
}


def key_extremes_bits_plain(bits) -> torch.Tensor:
    """Plain version of K23: int64 [n, 2], the least and the largest
    unsigned total-order key (``ops.keys``, -0.0 as +0.0) of each row of
    ``bits`` (int64 [n, 1024] f64 bit patterns), every value counted."""
    keys = biased_keys(bits)
    return bias(torch.stack([keys.amin(dim=1), keys.amax(dim=1)], dim=1))


@tracing.kernel
def key_extremes_bits_f64(bits) -> torch.Tensor:
    """K23: bits int64 [n, 1024] decoded f64 bit patterns -> int64 [n, 2]
    (least, largest) unsigned keys of each vector."""
    n = bits.shape[0]
    device = bits.device
    _check("bits", bits, torch.int64, (n, VECTOR_SIZE), device)
    if _device_kind(bits) == "cpu":
        return key_extremes_bits_plain(bits)
    out = torch.empty((n, 2), dtype=torch.int64, device=device)
    _launch("key_extremes_bits_f64", device, _ptr(bits), n, _ptr(out),
            device.index)
    LAUNCHES["key_extremes_bits"] += 1
    return out
