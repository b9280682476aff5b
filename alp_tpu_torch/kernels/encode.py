"""The port's ALP f64 encode kernel: wrapper, plain PyTorch version, count.

    K9 alp_encode_f64  <- alp_tpu/kernels/encode.py alp_encode_f64_tiles_stats
                          (stats on) and alp_encode_f64_tiles (stats off)

``alp_encode_f64(values, e, f, stats=True)`` encodes every value of
``values`` [n, 1024] (float64) with its vector's pair (e[v], f[v]) as the
host engine's encode_simdized does: NaN, +-Inf and -0.0 replaced by
ENCODING_UPPER_LIMIT, the magic round, the x86 cast, and the decode
compared bit for bit.  A CUDA tensor goes through the hand-written kernel
in ``csrc/encode.cu`` on the current stream of its card, without a
synchronise; a CPU tensor through the plain version beside it, which
repeats the arithmetic with PyTorch ops (separate ops, so nothing is fused
into an FMA).  ``LAUNCHES`` counts kernel launches; plain runs do not
count.

This module also keeps what K9 and K11 (``kernels.score``) share: the
constant tables on a device (``tables``) and the plain encode steps.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import constants as C
from .falp import VECTOR_SIZE, _check, _device_kind, _launch, _ptr

LAUNCHES = {"alp_encode_f64": 0}
INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1
_TWO63 = 2.0 ** 63


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class Tables:
    """The f64 constant tables (``constants.DOUBLE``) on one device, and
    the encode's two scalars."""
    exp: torch.Tensor          # float64: 10^i
    frac: torch.Tensor         # float64: 10^-i
    fact: torch.Tensor         # int64: 10^i
    magic: float               # 2^52 + 2^51
    upper: float               # ENCODING_UPPER_LIMIT

    def pointers(self) -> tuple:
        return (_ptr(self.exp), _ptr(self.frac), _ptr(self.fact),
                self.magic, self.upper)


def tables(device) -> Tables:
    return _tables(str(torch.device(device)))


def check_pairs(name: str, idx: torch.Tensor) -> None:
    """Exponents and factors index the tables: each must lie in
    0..max_exponent (one synchronising read of their range)."""
    if idx.numel():
        lo, hi = (int(x) for x in torch.aminmax(idx))
        if lo < 0 or hi > C.DOUBLE.max_exponent:
            raise ValueError(f"{name}: exponents and factors lie in "
                             f"0..{C.DOUBLE.max_exponent}, got {lo}..{hi}")


@functools.cache
def _tables(device: str) -> Tables:
    tc = C.DOUBLE
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


# ---------------------------------------------------------------------------
# K9
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
    ok = ~exc
    k = torch.arange(VECTOR_SIZE, device=values.device)
    return (n, exc, exc.sum(dim=1, dtype=torch.int32),
            torch.where(ok, k, VECTOR_SIZE).amin(dim=1).to(torch.int32),
            torch.where(ok, n, INT64_MAX).amin(dim=1),
            torch.where(ok, n, INT64_MIN).amax(dim=1))


def alp_encode_f64(values, e, f, stats=True) -> tuple:
    """K9.  values: float64 [n, 1024]; e, f: int32 [n], each vector's
    exponent and factor.  Returns n (int64 [n, 1024], the encoded
    integers, exception slots not patched) and exc (bool [n, 1024]); with
    ``stats``, also per vector the exception count (int32), the first
    non-exception index in value order (int32, 1024 when none) and the
    int64 min and max of n over the non-exceptions (INT64_MAX and
    INT64_MIN when none)."""
    n_vec = values.shape[0]
    device = values.device
    _check("values", values, torch.float64, (n_vec, VECTOR_SIZE), device)
    _check("e", e, torch.int32, (n_vec,), device)
    _check("f", f, torch.int32, (n_vec,), device)
    check_pairs("e", e)
    check_pairs("f", f)
    if _device_kind(values) == "cpu":
        return encode_plain(values, e, f, stats)
    n = torch.empty((n_vec, VECTOR_SIZE), dtype=torch.int64, device=device)
    exc = torch.empty((n_vec, VECTOR_SIZE), dtype=torch.bool, device=device)
    out = (n, exc)
    if stats:
        out += (torch.empty(n_vec, dtype=torch.int32, device=device),
                torch.empty(n_vec, dtype=torch.int32, device=device),
                torch.empty(n_vec, dtype=torch.int64, device=device),
                torch.empty(n_vec, dtype=torch.int64, device=device))
    stat_ptrs = [_ptr(x) for x in out[2:]] if stats else [None] * 4
    _launch("encode_f64", device, _ptr(values), _ptr(e), _ptr(f),
            *tables(device).pointers(), n_vec, _ptr(n), _ptr(exc),
            *stat_ptrs)
    LAUNCHES["alp_encode_f64"] += 1
    return out
