"""The port's exact-SUM kernels: wrappers, plain PyTorch versions, counts.

Each wrapper adds the superaccumulator digits of its values into ``out``,
an int64 ``[W + 3]`` column total (``totals(dtype, device)``): W windows of
32 bits over the whole exponent range (66 for f64, 9 for f32), then the
counts of NaN, +Inf and -Inf.  ``engine`` joins the windows with Python
integers and rounds once.  Position ``vec * 1024 + k >= n_values`` is the
container's pad and is skipped, with ``vec`` the real vector id of each
row.  With ``key_range=(klo, khi)`` (unsigned IEEE-754 total-order keys,
``ops.keys``) a value is summed only if ``klo <= key <= khi``: the
filtered instantiation of the same kernel, ``query_filter_sum``'s path.

A CUDA tensor goes through the hand-written kernel in
``csrc/exact_sum.cu``, on the current stream of the tensors' card, its
grid sized by that card's SM count, without a synchronise;
a CPU tensor goes through the plain version beside it.  Integer sums are
exact in any order, so the kernel's atomics give the plain version's
totals exactly (tolerance 0).  ``LAUNCHES`` counts kernel launches per
wrapper; plain runs do not count.

    K5 exact_sum_f64              <- alp_tpu/kernels/falp.py
                                     exact_sum_planes_f64
    K6 exact_sum_f32              <- exact_sum_planes_f32
    K7 falp_decode_f64_exact_sum  <- falp_decode_f64_variant_exact_sum
                                     (every variant and const)
    K8 falp_decode_f32_exact_sum  <- falp_decode_f32_exact_sum

The bound of each, and what the kernel's design does about it, are in the
head of ``csrc/exact_sum.cu``.
"""

from __future__ import annotations

import torch

from ..ops.fastlanes import widen
from ..ops.keys import in_key_range
from .falp import (VECTOR_SIZE, _check, _device_kind, _launch, _ptr,
                   falp_plain)

WINDOWS = {torch.int64: 66, torch.int32: 9}   # bit-pattern dtype -> W
# |digit| < 2^32: fewer than 2^31 values keep one int64 total exact, so a
# call sums fewer than MAX_VALUES values (its rows times 1024) into ``out``
# and ``engine.exact_sum_totals`` gives each such run its own total
MAX_VALUES = 1 << 31
LAUNCHES = {"exact_sum_f64": 0, "exact_sum_f32": 0,
            "falp_decode_f64_exact_sum": 0, "falp_decode_f32_exact_sum": 0}

_M32 = 0xFFFFFFFF
# bit-pattern dtype -> (word bits, exponent bits, mantissa bits)
_FIELDS = {torch.int64: (64, 11, 52), torch.int32: (32, 8, 23)}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def totals(dtype: torch.dtype, device) -> torch.Tensor:
    """A zero column total for bit patterns of ``dtype`` (int64: f64,
    int32: f32)."""
    return torch.zeros(WINDOWS[dtype] + 3, dtype=torch.int64, device=device)


def _check_size(n_rows: int, n_values: int) -> None:
    if n_values < 0:
        raise ValueError(f"n_values {n_values} is negative")
    if n_rows * VECTOR_SIZE >= MAX_VALUES:
        raise ValueError(f"{n_rows} rows: one call sums fewer than 2^31 "
                         "values, or its int64 totals could overflow")


def _out(out, dtype, device):
    if out is None:
        return totals(dtype, device)
    _check("out", out, torch.int64, (WINDOWS[dtype] + 3,), device)
    return out


def digit_rows(bits: torch.Tensor, row: torch.Tensor,
               n_rows: int) -> torch.Tensor:
    """int64 [n_rows, W + 3]: each value of the 1-D bit patterns ``bits``
    (int64 f64 or int32 f32) added into row ``row`` of its own (int64, the
    same shape) -- its signed digits into the windows, a NaN, +Inf or -Inf
    into its count.  K5-K8 sum into one row; K18 (``kernels.group``) into
    a row a vector and K19 into a row a group."""
    S, EB, MB = _FIELDS[bits.dtype]
    W = WINDOWS[bits.dtype]
    b = widen(bits, S)
    e = (b >> MB) & ((1 << EB) - 1)
    m = b & ((1 << MB) - 1)
    neg = ((b >> (S - 1)) & 1) != 0
    special = e == (1 << EB) - 1
    mp = torch.where(e > 0, m | (1 << MB), m)
    mp = torch.where(special, torch.zeros_like(mp), mp)
    ee = e.clamp(min=1)
    j = ee >> 5
    sh = ee & 31
    lo = mp << sh                          # the low 64 bits of c (wraps)
    digits = [lo & _M32, (lo >> 32) & _M32]
    if S == 64:
        digits.append((mp >> 1) >> (63 - sh))        # c >> 64, < 2^20
    at = row * (W + 3)
    out = torch.zeros(n_rows * (W + 3), dtype=torch.int64,
                      device=bits.device)
    for p, d in enumerate(digits):
        out.index_add_(0, at + j + p, torch.where(neg, -d, d))
    for c, cls in enumerate((special & (m != 0), special & (m == 0) & ~neg,
                             special & (m == 0) & neg)):
        out.index_add_(0, at[cls] + W + c, torch.ones_like(at[cls]))
    return out.view(n_rows, W + 3)


def exact_sum_plain(bits: torch.Tensor, vec: torch.Tensor,
                    n_values: int, key_range=None) -> torch.Tensor:
    """Plain version of K5/K6: the int64 [W + 3] totals of ``bits``
    [n, 1024] (int64 f64 or int32 f32 patterns), row i being vector
    ``vec[i]``; with ``key_range``, of the values whose key lies in it."""
    pos = vec[:, None] * VECTOR_SIZE + torch.arange(VECTOR_SIZE,
                                                    device=bits.device)
    keep = pos < n_values
    if key_range is not None:
        keep &= in_key_range(bits, *key_range)
    b = bits[keep]
    return digit_rows(b, torch.zeros_like(b, dtype=torch.int64), 1)[0]


def _key_range_args(key_range, S: int) -> tuple:
    """The C arguments of a key range: () for none, else (klo, khi) as
    unsigned S-bit keys; raises on a key out of range."""
    if key_range is None:
        return ()
    klo, khi = (int(k) for k in key_range)
    if not (0 <= klo < 1 << S and 0 <= khi < 1 << S):
        raise ValueError(f"key range {key_range} out of 0..2^{S} - 1")
    return klo, khi


def _entry(name: str, key_range) -> str:
    """The C entry of a SUM kernel, filtered (``_where``) or not."""
    if key_range is None:
        return name
    head, width = name.rsplit("_", 1)
    return f"{head}_where_{width}"


def _exact_sum(bits, vec, n_values, out, kernel, key_range):
    n = bits.shape[0]
    device = bits.device
    _check("bits", bits, bits.dtype, (n, VECTOR_SIZE), device)
    _check("vec", vec, torch.int64, (n,), device)
    _check_size(n, n_values)
    keys = _key_range_args(key_range, _FIELDS[bits.dtype][0])
    out = _out(out, bits.dtype, device)
    if _device_kind(bits) == "cpu":
        out += exact_sum_plain(bits, vec, n_values, key_range)
        return out
    _launch(_entry(kernel, key_range), device, _ptr(bits), _ptr(vec), n,
            n_values, *keys, _ptr(out), device.index)
    LAUNCHES[kernel] += 1
    return out


def exact_sum_f64(bits, vec, n_values, out=None, key_range=None):
    """K5.  bits: int64 [n, 1024] decoded f64 patterns; vec: int64 [n],
    the vector id of each row; adds into ``out`` (int64 [69]); with
    ``key_range=(klo, khi)`` only the values whose key lies in it."""
    if bits.dtype != torch.int64:
        raise TypeError("exact_sum_f64 takes int64 bit patterns")
    return _exact_sum(bits, vec, n_values, out, "exact_sum_f64", key_range)


def exact_sum_f32(bits, vec, n_values, out=None, key_range=None):
    """K6: the f32 twin of K5 (int32 patterns; ``out`` int64 [12])."""
    if bits.dtype != torch.int32:
        raise TypeError("exact_sum_f32 takes int32 bit patterns")
    return _exact_sum(bits, vec, n_values, out, "exact_sum_f32", key_range)


def csr_entries(exc_ptr, rows) -> tuple:
    """(row i, entry) of every exception of vectors ``rows`` in a plan's
    per-vector CSR: vector v's exceptions are entries exc_ptr[v] ..
    exc_ptr[v + 1]."""
    first = exc_ptr[rows]
    count = exc_ptr[rows + 1] - first
    total = int(count.sum())
    starts = torch.cumsum(count, 0) - count
    entry = (torch.repeat_interleave(first - starts, count)
             + torch.arange(total, device=rows.device))
    row = torch.repeat_interleave(
        torch.arange(rows.shape[0], device=rows.device), count)
    return row, entry


def patch_exceptions(bits, rows, exc_ptr, exc_index, exc_bits) -> None:
    """Write the true bits of every exception of vectors ``rows`` into
    ``bits`` [n, 1024] (row i = vector rows[i]), from the plan's per-vector
    CSR: vector v's exceptions are entries exc_ptr[v] .. exc_ptr[v + 1] of
    ``exc_index`` (flat positions v * 1024 + k) and ``exc_bits``."""
    row, entry = csr_entries(exc_ptr, rows)
    if entry.numel():
        bits[row, exc_index[entry] & (VECTOR_SIZE - 1)] = exc_bits[entry]


def falp_bits_plain(packed, bw, base, fact, frac, rows, exc_ptr,
                    exc_index, exc_bits) -> torch.Tensor:
    """An ALP bucket's bit patterns [n, 1024] with its exceptions in:
    K1/K2's plain decode, then the true bits from the CSR."""
    bits = falp_plain(packed, bw, base, fact, frac).view(base.dtype)
    patch_exceptions(bits, rows, exc_ptr, exc_index, exc_bits)
    return bits


def falp_exact_sum_plain(packed, bw, base, fact, frac, rows, exc_ptr,
                         exc_index, exc_bits, n_values,
                         key_range=None) -> torch.Tensor:
    """Plain version of K7/K8: K1/K2's plain decode, the exceptions
    written in, then K5/K6's plain sum."""
    return exact_sum_plain(falp_bits_plain(packed, bw, base, fact, frac,
                                           rows, exc_ptr, exc_index,
                                           exc_bits),
                           rows, n_values, key_range)


_FALP = {  # value dtype -> (word dtype, word bits, C entry, count key)
    torch.float64: (torch.int64, 64, "falp_exact_sum_f64",
                    "falp_decode_f64_exact_sum"),
    torch.float32: (torch.int32, 32, "falp_exact_sum_f32",
                    "falp_decode_f32_exact_sum"),
}


def _falp_exact_sum(packed, bw, base, fact, frac, rows, exc_ptr, exc_index,
                    exc_bits, n_values, out, key_range, ftype):
    wtype, S, entry, count = _FALP[ftype]
    n = packed.shape[0]
    device = packed.device
    _check("packed", packed, wtype, (n, bw * (VECTOR_SIZE // S)), device)
    for nm, t, dt in (("base", base, wtype), ("fact", fact, wtype),
                      ("frac", frac, ftype), ("rows", rows, torch.int64)):
        _check(nm, t, dt, (n,), device)
    if exc_ptr.dim() != 1 or exc_ptr.shape[0] < 1:
        raise ValueError("exc_ptr must be [n_vectors + 1]")
    _check("exc_ptr", exc_ptr, torch.int64, exc_ptr.shape, device)
    n_exc = exc_index.shape[0]
    _check("exc_index", exc_index, torch.int64, (n_exc,), device)
    _check("exc_bits", exc_bits, wtype, (n_exc,), device)
    if not 0 <= bw <= S:
        raise ValueError(f"bit width {bw} out of range 0..{S}")
    _check_size(n, n_values)
    keys = _key_range_args(key_range, S)
    out = _out(out, wtype, device)
    if _device_kind(packed) == "cpu":
        out += falp_exact_sum_plain(packed, bw, base, fact, frac, rows,
                                    exc_ptr, exc_index, exc_bits, n_values,
                                    key_range)
        return out
    _launch(_entry(entry, key_range), device, _ptr(packed), bw, _ptr(base),
            _ptr(fact), _ptr(frac), _ptr(rows), _ptr(exc_ptr),
            _ptr(exc_index), _ptr(exc_bits), n, n_values, *keys, _ptr(out),
            device.index)
    LAUNCHES[count] += 1
    return out


def falp_decode_f64_exact_sum(packed, bw, base, fact, frac, rows, exc_ptr,
                              exc_index, exc_bits, n_values, out=None,
                              key_range=None):
    """K7.  K1's arguments (packed int64 [n, bw * 16], base, fact int64
    [n], frac float64 [n]) plus rows (int64 [n] vector ids), the plan's
    exception CSR (exc_ptr int64 [n_vectors + 1]; exc_index int64 flat
    positions and exc_bits int64 patterns, [n_exc]) and n_values; adds
    into ``out`` (int64 [69]); with ``key_range=(klo, khi)`` only the
    values whose key lies in it."""
    return _falp_exact_sum(packed, bw, base, fact, frac, rows, exc_ptr,
                           exc_index, exc_bits, n_values, out, key_range,
                           torch.float64)


def falp_decode_f32_exact_sum(packed, bw, base, fact, frac, rows, exc_ptr,
                              exc_index, exc_bits, n_values, out=None,
                              key_range=None):
    """K8: the f32 twin of K7 (int32 words and patterns, float32 frac;
    ``out`` int64 [12])."""
    return _falp_exact_sum(packed, bw, base, fact, frac, rows, exc_ptr,
                           exc_index, exc_bits, n_values, out, key_range,
                           torch.float32)


# kernel name (a key of LAUNCHES) -> (wrapper, plain version), each taking
# the same positional arguments and ``key_range``
KERNELS = {
    "exact_sum_f64": (exact_sum_f64, exact_sum_plain),
    "exact_sum_f32": (exact_sum_f32, exact_sum_plain),
    "falp_decode_f64_exact_sum": (falp_decode_f64_exact_sum,
                                  falp_exact_sum_plain),
    "falp_decode_f32_exact_sum": (falp_decode_f32_exact_sum,
                                  falp_exact_sum_plain),
}
