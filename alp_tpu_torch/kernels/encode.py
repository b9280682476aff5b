"""The port's ALP encode kernels: wrappers, plain PyTorch versions, counts.

    K9  alp_encode_f64  <- alp_tpu/kernels/encode.py alp_encode_f64_tiles_stats
                           (stats on) and alp_encode_f64_tiles (stats off)
    K12 alp_encode_f32  <- alp_encode_f32_tiles_stats (stats on) and
                           alp_encode_f32_tiles (stats off)

``alp_encode_f64(values, e, f, stats=True)`` encodes every value of
``values`` [n, 1024] (float64) with its vector's pair (e[v], f[v]) as the
host engine's encode_simdized does: NaN, +-Inf and -0.0 replaced by
ENCODING_UPPER_LIMIT, the magic round, the x86 cast, and the decode
compared bit for bit.  ``alp_encode_f32`` is its float32 twin (int32 n,
the decode compared as a float, the pair f == 10 past the FACT table
always an exception).  A CUDA tensor goes through the hand-written kernels
in ``csrc/encode.cu`` on the current stream of its card, without a
synchronise; a CPU tensor through the plain versions beside them, which
repeat the arithmetic with PyTorch ops (separate ops, so nothing is fused
into an FMA).  ``LAUNCHES`` counts kernel launches; plain runs do not
count.

This module also keeps what the encode and the scorers (``kernels.score``)
share: the constant tables on a device (``tables``) and the plain encode
steps.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import constants as C
from ..ops.fastlanes import narrow
from .falp import VECTOR_SIZE, _check, _device_kind, _launch, _ptr

LAUNCHES = {"alp_encode_f64": 0, "alp_encode_f32": 0}
INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1
INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1
_TWO63 = 2.0 ** 63
_TWO31 = 2.0 ** 31


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class Tables:
    """One precision's constant tables (``constants.DOUBLE`` or
    ``constants.FLOAT``) on one device, and the encode's two scalars."""
    exp: torch.Tensor          # float: 10^i
    frac: torch.Tensor         # float: 10^-i
    fact: torch.Tensor         # int64 / int32: 10^i
    magic: float               # 2^52 + 2^51 / 2^23 + 2^22
    upper: float               # ENCODING_UPPER_LIMIT in the precision

    def pointers(self) -> tuple:
        """The tables' arguments of the precision's C entries: f32 adds the
        FACT table's length and ENCODING_UPPER_LIMIT as a double."""
        head = (_ptr(self.exp), _ptr(self.frac), _ptr(self.fact))
        if self.exp.dtype == torch.float64:
            return head + (self.magic, self.upper)
        return head + (self.fact.numel(), self.magic, self.upper,
                       C.ENCODING_UPPER_LIMIT)


def tables(device, tc=C.DOUBLE) -> Tables:
    return _tables(str(torch.device(device)), tc.pt == C.DOUBLE.pt)


def check_pairs(name: str, idx: torch.Tensor, tc=C.DOUBLE) -> None:
    """Exponents and factors index the tables: each must lie in
    0..max_exponent (one synchronising read of their range)."""
    if idx.numel():
        lo, hi = (int(x) for x in torch.aminmax(idx))
        if lo < 0 or hi > tc.max_exponent:
            raise ValueError(f"{name}: exponents and factors lie in "
                             f"0..{tc.max_exponent}, got {lo}..{hi}")


@functools.cache
def _tables(device: str, f64: bool) -> Tables:
    tc = C.DOUBLE if f64 else C.FLOAT
    return Tables(torch.from_numpy(tc.exp_arr).to(device),
                  torch.from_numpy(tc.frac_arr).to(device),
                  torch.from_numpy(tc.fact_arr).to(device),
                  float(tc.magic_number), float(tc.encoding_upper_limit_pt))


# ---------------------------------------------------------------------------
# plain encode steps (csrc/encode.cuh, step for step)
# ---------------------------------------------------------------------------

def cast_x86(r: torch.Tensor) -> torch.Tensor:
    """x86 cvttsd2si: truncation; NaN and values outside [-2^63, 2^63)
    give INT64_MIN."""
    ok = (r >= -_TWO63) & (r < _TWO63)
    n = torch.where(ok, r, 0.0).to(torch.int64)
    return torch.where(ok, n, INT64_MIN)


def round_cast(s: torch.Tensor, magic: float) -> torch.Tensor:
    return cast_x86((s + magic) - magic)


def decoded_bits(n: torch.Tensor, fact: torch.Tensor,
                 frac: torch.Tensor) -> torch.Tensor:
    """int64 bits of RN(RN(double(wrap64(n * FACT))) * FRAC)."""
    return ((n * fact).to(torch.float64) * frac).view(torch.int64)


def is_special(bits: torch.Tensor) -> torch.Tensor:
    """NaN, +-Inf and -0.0 among int64 f64 bit patterns."""
    return (((bits & 0x7FFFFFFFFFFFFFFF) >= 0x7FF0000000000000)
            | (bits == INT64_MIN))


def cast_x86_32(r: torch.Tensor) -> torch.Tensor:
    """x86 cvttss2si: truncation; NaN and values outside [-2^31, 2^31)
    give INT32_MIN."""
    ok = (r >= -_TWO31) & (r < _TWO31)
    n = torch.where(ok, r, 0.0).to(torch.int32)
    return torch.where(ok, n, INT32_MIN)


def round_cast32(s: torch.Tensor, magic: float) -> torch.Tensor:
    return cast_x86_32((s + magic) - magic)


def decodes_to32(n, e, f, v, t: Tables) -> torch.Tensor:
    """decode_value32(n, f, e) == v as floats: RN(float(int32(uint32(n) *
    FACT[f]))) * 10^-e, the product taken in int64 and narrowed to 32 bits;
    False where f is past the FACT table (the reference's NaN decode), which
    is never indexed."""
    last = t.fact.numel() - 1
    m = narrow(n.to(torch.int64) * t.fact[f.clamp(max=last)].to(torch.int64),
               32)
    return (m.to(torch.float32) * t.frac[e] == v) & (f <= last)


def is_special32(bits: torch.Tensor) -> torch.Tensor:
    """NaN, +-Inf and -0.0 among int32 f32 bit patterns."""
    return ((bits & 0x7FFFFFFF) >= 0x7F800000) | (bits == INT32_MIN)


def _stats(n, exc, lo: int, hi: int) -> tuple:
    """exc_count, first non-exception index, min and max of n over the
    non-exceptions (``hi`` and ``lo`` when none), per vector."""
    ok = ~exc
    k = torch.arange(VECTOR_SIZE, device=n.device)
    return (exc.sum(dim=1, dtype=torch.int32),
            torch.where(ok, k, VECTOR_SIZE).amin(dim=1).to(torch.int32),
            torch.where(ok, n, hi).amin(dim=1),
            torch.where(ok, n, lo).amax(dim=1))


# ---------------------------------------------------------------------------
# K9 / K12
# ---------------------------------------------------------------------------

def encode_plain(values, e, f, stats=True) -> tuple:
    """Plain version of K9: (n, exc) or (n, exc, exc_count, first, vmin,
    vmax), as ``alp_encode_f64`` returns."""
    t = tables(values.device)
    e, f = e.to(torch.int64), f.to(torch.int64)
    vr = torch.where(is_special(values.view(torch.int64)), t.upper, values)
    s = (vr * t.exp[e][:, None]) * t.frac[f][:, None]
    n = round_cast(s, t.magic)
    exc = decoded_bits(n, t.fact[f][:, None], t.frac[e][:, None]) != \
        vr.view(torch.int64)
    if not stats:
        return n, exc
    return (n, exc) + _stats(n, exc, INT64_MIN, INT64_MAX)


def encode_plain_f32(values, e, f, stats=True) -> tuple:
    """Plain version of K12: (n, exc) or (n, exc, exc_count, first, vmin,
    vmax), as ``alp_encode_f32`` returns."""
    t = tables(values.device, C.FLOAT)
    e, f = e.to(torch.int64)[:, None], f.to(torch.int64)[:, None]
    vr = torch.where(is_special32(values.view(torch.int32)), t.upper, values)
    s = (vr * t.exp[e]) * t.frac[f]
    n = round_cast32(s, t.magic)
    exc = ~decodes_to32(n, e, f, vr, t)
    if not stats:
        return n, exc
    return (n, exc) + _stats(n, exc, INT32_MIN, INT32_MAX)


def _encode(values, e, f, stats, tc, checked) -> tuple:
    f64 = tc is C.DOUBLE
    ftype, itype = ((torch.float64, torch.int64) if f64
                    else (torch.float32, torch.int32))
    n_vec = values.shape[0]
    device = values.device
    _check("values", values, ftype, (n_vec, VECTOR_SIZE), device)
    _check("e", e, torch.int32, (n_vec,), device)
    _check("f", f, torch.int32, (n_vec,), device)
    if checked:
        check_pairs("e", e, tc)
        check_pairs("f", f, tc)
    if _device_kind(values) == "cpu":
        return (encode_plain if f64 else encode_plain_f32)(values, e, f,
                                                           stats)
    n = torch.empty((n_vec, VECTOR_SIZE), dtype=itype, device=device)
    exc = torch.empty((n_vec, VECTOR_SIZE), dtype=torch.bool, device=device)
    out = (n, exc)
    if stats:
        out += (torch.empty(n_vec, dtype=torch.int32, device=device),
                torch.empty(n_vec, dtype=torch.int32, device=device),
                torch.empty(n_vec, dtype=itype, device=device),
                torch.empty(n_vec, dtype=itype, device=device))
    stat_ptrs = [_ptr(x) for x in out[2:]] if stats else [None] * 4
    name = "encode_f64" if f64 else "encode_f32"
    _launch(name, device, _ptr(values), _ptr(e), _ptr(f),
            *tables(device, tc).pointers(), n_vec, _ptr(n), _ptr(exc),
            *stat_ptrs)
    LAUNCHES["alp_" + name] += 1
    return out


def alp_encode_f64(values, e, f, stats=True, *, checked=True) -> tuple:
    """K9.  values: float64 [n, 1024]; e, f: int32 [n], each vector's
    exponent and factor.  Returns n (int64 [n, 1024], the encoded
    integers, exception slots not patched) and exc (bool [n, 1024]); with
    ``stats``, also per vector the exception count (int32), the first
    non-exception index in value order (int32, 1024 when none) and the
    int64 min and max of n over the non-exceptions (INT64_MAX and
    INT64_MIN when none).  ``checked=False`` skips the synchronising read
    of the pairs' range, for callers whose pairs lie in the tables by
    construction (the device planner's)."""
    return _encode(values, e, f, stats, C.DOUBLE, checked)


def alp_encode_f32(values, e, f, stats=True, *, checked=True) -> tuple:
    """K12, the float32 twin of K9.  values: float32 [n, 1024]; e, f: int32
    [n] in 0..10.  Returns n (int32 [n, 1024]) and exc (bool [n, 1024]);
    with ``stats``, also the exception count and first non-exception index
    (int32) and the int32 min and max of n over the non-exceptions
    (INT32_MAX and INT32_MIN when none); ``checked`` as K9's."""
    return _encode(values, e, f, stats, C.FLOAT, checked)
