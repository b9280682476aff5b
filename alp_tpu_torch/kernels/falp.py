"""The port's decode kernels: wrappers, plain PyTorch versions, counts.

Each wrapper takes one bucket of vectors that share a bit width and writes
their decoded values into rows ``rows`` of ``out`` (a fresh
``[n, 1024]`` tensor from ``torch.empty`` when ``out`` is None).  A CUDA
tensor goes through the hand-written kernel in ``csrc/falp.cu`` (built by
``_build``), on the current stream of the tensors' card, without a
synchronise; a launch
that is refused raises.  A CPU tensor goes through the plain version
beside it, which computes the same function with PyTorch ops: unFFOR from
``ops.fastlanes``, the wrapping integer product, ``.to(float)`` (round to
nearest) and the multiply by FRAC.  ``LAUNCHES`` counts kernel launches
per wrapper; plain runs do not count.

    K1 falp_decode_f64     <- alp_tpu/kernels/falp.py falp_decode_f64,
                              _small, _mid, _mid64, _midc96, _const
    K2 falp_decode_f32     <- falp_decode_f32
    K3 rd_decode_dict_f64  <- rd_decode_dict_f64
    K4 rd_decode_dict_f32  <- rd_decode_dict_f32

and two that serve the bench's steps and rows, not ``DecodePlan``:

    K20 variant_sum_f64    <- falp_decode_f64_variant_sum: K1's decode,
                              each value cut to float by the reference's
                              truncating convert, summed per FastLanes lane
                              into [n, 16] floats (a checksum, not a SUM)
    K21 rd_glue_f64 / _f32 <- rd_decode_f64, rd_decode_f32: ALP_RD with the
                              left parts already resolved, [n, 1024] bits

The bound of each, and what the kernel's design does about it, are in the
head of ``csrc/falp.cu``.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..ops.fastlanes import narrow, unffor_unpack, widen
from . import _build

VECTOR_SIZE = 1024
LAUNCHES = tracing.Counters("alp.launch.", (
    "falp_decode_f64", "falp_decode_f32", "rd_decode_dict_f64",
    "rd_decode_dict_f32", "variant_sum_f64", "rd_glue_f64", "rd_glue_f32"))
LANES_F64 = VECTOR_SIZE // 64           # FastLanes lanes of an f64 vector


reset_launches = LAUNCHES.reset


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _out(out, rows, n, dtype, device):
    """Validated (out, rows): a fresh [n, 1024] tensor when out is None."""
    if out is None:
        if rows is not None:
            raise ValueError("rows needs out")
        return torch.empty((n, VECTOR_SIZE), dtype=dtype, device=device), None
    if out.dim() != 2 or out.shape[1] != VECTOR_SIZE:
        raise ValueError("out must be [N, 1024]")
    _check("out", out, dtype, out.shape, device)
    if rows is None:
        if out.shape[0] != n:
            raise ValueError("out without rows must have one row per vector")
    else:
        _check("rows", rows, torch.int64, (n,), device)
    return out, rows


def _store(out, rows, vals):
    if rows is None:
        out.copy_(vals)
    else:
        out[rows] = vals


def _launch(name, device, *args):
    """Run the C entry ``alp_<name>`` on ``device``, the card of the
    kernel's tensors: that card is made current for the call and the
    launch goes to its current stream, whichever card was current."""
    with torch.cuda.device(device):
        status = getattr(_build.lib(), "alp_" + name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if status:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                           f"error {status}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# K1 / K2: fused unFFOR + falp
# ---------------------------------------------------------------------------

_FALP = {  # value dtype -> (word dtype, word bits, kernel, launch count key)
    torch.float64: (torch.int64, 64, "falp_f64", "falp_decode_f64"),
    torch.float32: (torch.int32, 32, "falp_f32", "falp_decode_f32"),
}


def _falp(packed, bw, base, fact, frac, out, rows, ftype):
    wtype, S, kernel, count = _FALP[ftype]
    n = packed.shape[0]
    device = packed.device
    _check("packed", packed, wtype, (n, bw * (VECTOR_SIZE // S)), device)
    for nm, t, dt in (("base", base, wtype), ("fact", fact, wtype),
                      ("frac", frac, ftype)):
        _check(nm, t, dt, (n,), device)
    if not 0 <= bw <= S:
        raise ValueError(f"bit width {bw} out of range 0..{S}")
    out, rows = _out(out, rows, n, ftype, device)
    if _device_kind(packed) == "cpu":
        _store(out, rows, falp_plain(packed, bw, base, fact, frac))
        return out
    _launch(kernel, device, _ptr(packed), bw, _ptr(base), _ptr(fact),
            _ptr(frac), _ptr(rows), _ptr(out), n)
    LAUNCHES[count] += 1
    return out


def falp_plain(packed, bw, base, fact, frac) -> torch.Tensor:
    """Plain version of K1/K2: [n, 1024] values of ``frac``'s dtype."""
    m = unffor_unpack(packed, base, bw) * fact[:, None]   # wrapping product
    return m.to(frac.dtype) * frac[:, None]


@tracing.kernel
def falp_decode_f64(packed, bw, base, fact, frac, out=None, rows=None):
    """K1.  packed: int64 [n, bw * 16] FFOR words; base, fact: int64 [n]
    (FOR base, 10^fac); frac: float64 [n] (10^-exp); bw in 0..64."""
    return _falp(packed, bw, base, fact, frac, out, rows, torch.float64)


@tracing.kernel
def falp_decode_f32(packed, bw, base, fact, frac, out=None, rows=None):
    """K2.  packed: int32 [n, bw * 32]; base, fact: int32 [n]; frac:
    float32 [n]; bw in 0..32."""
    return _falp(packed, bw, base, fact, frac, out, rows, torch.float32)


# ---------------------------------------------------------------------------
# K3 / K4: ALP_RD dictionary decode + glue
# ---------------------------------------------------------------------------

_RD = {  # pattern dtype -> (word bits, kernel, launch count key)
    torch.int64: (64, "rd_f64", "rd_decode_dict_f64"),
    torch.int32: (32, "rd_f32", "rd_decode_dict_f32"),
}


def _rd(right, rbw, left, lbw, dictionary, dict_size, out, rows):
    S, kernel, count = _RD[right.dtype]
    n = right.shape[0]
    device = right.device
    if not (0 <= rbw <= S and 0 <= lbw <= 16):
        raise ValueError(f"RD bit widths {rbw}/{lbw} out of range")
    _check("right", right, right.dtype, (n, rbw * (VECTOR_SIZE // S)), device)
    _check("left", left, torch.int16, (n, lbw * (VECTOR_SIZE // 16)), device)
    _check("dictionary", dictionary, torch.int16, (n, 8), device)
    _check("dict_size", dict_size, torch.int32, (n,), device)
    out, rows = _out(out, rows, n, right.dtype, device)
    if _device_kind(right) == "cpu":
        _store(out, rows, rd_plain(right, rbw, left, lbw, dictionary,
                                   dict_size))
        return out
    _launch(kernel, device, _ptr(right), rbw, _ptr(left), lbw,
            _ptr(dictionary), _ptr(dict_size), _ptr(rows), _ptr(out), n)
    LAUNCHES[count] += 1
    return out


def rd_plain(right, rbw, left, lbw, dictionary, dict_size) -> torch.Tensor:
    """Plain version of K3/K4: [n, 1024] bit patterns in ``right``'s
    dtype, before the exception scatter."""
    S = 64 if right.dtype == torch.int64 else 32
    n = right.shape[0]
    zeros = torch.zeros(n, dtype=right.dtype, device=right.device)
    r = widen(unffor_unpack(right, zeros, rbw), S)
    idx = widen(unffor_unpack(left, zeros.to(torch.int16), lbw), 16)
    last = (dict_size.to(torch.int64).clamp(max=8) - 1).clamp(min=0)
    idx = torch.minimum(idx, last[:, None])
    entries = torch.gather(widen(dictionary, 16), 1, idx)
    return narrow((entries << rbw) | r if rbw < S else r, S)


@tracing.kernel
def rd_decode_dict_f64(right, rbw, left, lbw, dictionary, dict_size,
                       out=None, rows=None):
    """K3.  right: int64 [n, rbw * 16] words of the right parts; left:
    int16 [n, lbw * 64] words of the dictionary indexes; dictionary:
    int16 [n, 8] (u16 entries of each vector's rowgroup); dict_size:
    int32 [n].  Writes f64 bit patterns (int64)."""
    if right.dtype != torch.int64:
        raise TypeError("rd_decode_dict_f64 takes int64 right-part words")
    return _rd(right, rbw, left, lbw, dictionary, dict_size, out, rows)


@tracing.kernel
def rd_decode_dict_f32(right, rbw, left, lbw, dictionary, dict_size,
                       out=None, rows=None):
    """K4: the f32 twin of K3 (int32 words, f32 bit patterns)."""
    if right.dtype != torch.int32:
        raise TypeError("rd_decode_dict_f32 takes int32 right-part words")
    return _rd(right, rbw, left, lbw, dictionary, dict_size, out, rows)


# ---------------------------------------------------------------------------
# K20: fused decode + per-lane truncating float sum
# ---------------------------------------------------------------------------

def trunc_f32_plain(bits: torch.Tensor) -> torch.Tensor:
    """The reference's truncating f64-bits -> float convert
    (``alp_tpu/kernels/falp.py`` ``_f64_bits_to_f32``), operation for
    operation on int64 bit patterns: the exponent rebased and clamped to
    [0, 254], the top 23 mantissa bits kept, the rest dropped (not IEEE
    rounding: +-Inf and NaN come out as large finite floats)."""
    hi = (bits >> 32) & 0xFFFFFFFF
    lo = bits & 0xFFFFFFFF
    sign = hi & 0x80000000
    e32 = (((hi >> 20) & 0x7FF) - 896).clamp(0, 254)
    m = ((hi & 0xFFFFF) << 3) | (lo >> 29)
    return narrow(sign | (e32 << 23) | m, 32).view(torch.float32)


def variant_sum_plain(packed, bw, base, fact, frac) -> torch.Tensor:
    """Plain version of K20: [n, 16] floats, lane l of vector v the float
    sum over slots s = 0..63, in that order, of the cut value 16 s + l of
    K1's decode (no exception written in, the pad summed as decoded)."""
    vals = falp_plain(packed, bw, base, fact, frac)
    terms = trunc_f32_plain(vals.view(torch.int64)).reshape(
        -1, VECTOR_SIZE // LANES_F64, LANES_F64)
    acc = torch.zeros((terms.shape[0], LANES_F64), dtype=torch.float32,
                      device=terms.device)
    for s in range(terms.shape[1]):
        acc = acc + terms[:, s]
    return acc


@tracing.kernel
def variant_sum_f64(packed, bw, base, fact, frac) -> torch.Tensor:
    """K20 over one f64 ALP bucket (K1's arguments): float32 [n, 16]."""
    n = packed.shape[0]
    device = packed.device
    if not 0 <= bw <= 64:
        raise ValueError(f"bit width {bw} out of range 0..64")
    _check("packed", packed, torch.int64, (n, bw * LANES_F64), device)
    for nm, t, dt in (("base", base, torch.int64),
                      ("fact", fact, torch.int64),
                      ("frac", frac, torch.float64)):
        _check(nm, t, dt, (n,), device)
    if _device_kind(packed) == "cpu":
        return variant_sum_plain(packed, bw, base, fact, frac)
    out = torch.empty((n, LANES_F64), dtype=torch.float32, device=device)
    _launch("variant_sum_f64", device, _ptr(packed), bw, _ptr(base),
            _ptr(fact), _ptr(frac), n, _ptr(out))
    LAUNCHES["variant_sum_f64"] += 1
    return out


# ---------------------------------------------------------------------------
# K21: ALP_RD glue of resolved left parts
# ---------------------------------------------------------------------------

_GLUE = {torch.int64: (64, 48, "rd_glue_f64"),   # word: (S, least rbw, key)
         torch.int32: (32, 0, "rd_glue_f32")}


def rd_glue_plain(right, rbw, left) -> torch.Tensor:
    """Plain version of K21: [n, 1024] bit patterns in ``right``'s dtype,
    ``(left << rbw) | right`` over the unFFORed right parts, the right
    parts alone at ``rbw == S``."""
    S = 64 if right.dtype == torch.int64 else 32
    zeros = torch.zeros(right.shape[0], dtype=right.dtype,
                        device=right.device)
    r = widen(unffor_unpack(right, zeros, rbw), S)
    glued = (widen(left, 32) << rbw) | r if rbw < S else r
    return narrow(glued, S)


def _rd_glue(right, rbw, left):
    S, least, key = _GLUE[right.dtype]
    n = right.shape[0]
    device = right.device
    if not least <= rbw <= S:
        raise ValueError(f"right bit width {rbw} out of range {least}..{S}")
    _check("right", right, right.dtype, (n, rbw * (VECTOR_SIZE // S)),
           device)
    _check("left", left, torch.int32, (n, VECTOR_SIZE), device)
    if _device_kind(right) == "cpu":
        return rd_glue_plain(right, rbw, left)
    out = torch.empty((n, VECTOR_SIZE), dtype=right.dtype, device=device)
    _launch(key, device, _ptr(right), rbw, _ptr(left), n, _ptr(out))
    LAUNCHES[key] += 1
    return out


@tracing.kernel
def rd_glue_f64(right, rbw, left) -> torch.Tensor:
    """K21 over f64 vectors.  right: int64 [n, rbw * 16] words of the
    right parts (FFOR base 0); left: int32 [n, 1024], each value's left
    part, resolved and patched; rbw in 48..64 (the reference cuts at most
    16 left bits).  Returns int64 [n, 1024] f64 bit patterns."""
    if right.dtype != torch.int64:
        raise TypeError("rd_glue_f64 takes int64 right-part words")
    return _rd_glue(right, rbw, left)


@tracing.kernel
def rd_glue_f32(right, rbw, left) -> torch.Tensor:
    """K21 over f32 vectors: int32 [n, rbw * 32] words, rbw in 0..32 (0:
    the left words are the bits).  Returns int32 [n, 1024] bit patterns."""
    if right.dtype != torch.int32:
        raise TypeError("rd_glue_f32 takes int32 right-part words")
    return _rd_glue(right, rbw, left)
