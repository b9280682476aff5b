"""The port's FFOR pack kernels: wrappers, plain PyTorch version, counts.

    K10 ffor_pack_f64  <- alp_tpu/kernels/falp.py _ffor_planes_call, through
                          ffor_planes_patch_f64 (exception slots patched)
                          and ffor_planes_f64 (no patch)
    K13 ffor_pack_f32  <- ffor_tile at element_bits=32
    K22 unffor         <- unffor_tile (element_bits 64 and 32): the
                          inverse, unFFOR alone, for the bench's rows

``ffor_pack_f64`` FOR-subtracts and bit-packs a bucket of int64 vectors
that share one bit width into the FastLanes words the ALPT blob stores, in
``ops.fastlanes.ffor_pack``'s order; ``ffor_pack_f32`` does the same over
int32 vectors (32 lanes, modulo 2^32).  A CUDA tensor goes through the
hand-written kernels in ``csrc/ffor.cu`` on the current stream of its
card, without a synchronise; a CPU tensor through the plain version
beside them: the exception patch, then ``ops.fastlanes.ffor_pack``.
``LAUNCHES`` counts kernel launches; plain runs do not count.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..ops.fastlanes import ffor_pack, unffor_unpack, word_bits
from .falp import VECTOR_SIZE, _check, _device_kind, _launch, _ptr

LAUNCHES = tracing.Counters("alp.launch.", (
    "ffor_pack_f64", "ffor_pack_f32", "unffor"))
# word dtype -> (word bits, C entry)
_WORDS = {torch.int64: (64, "ffor_pack_f64"), torch.int32: (32, "ffor_pack_f32")}


reset_launches = LAUNCHES.reset


def ffor_plain(values, base, bw, exc=None, fill=None, rows=None):
    """Plain version of K10 and K13: the [m, L * bw] words of the bucket
    (L = 16 for int64 values, 32 for int32)."""
    src = values if rows is None else values[rows]
    if exc is not None:
        patch = exc if rows is None else exc[rows]
        vfill = fill if rows is None else fill[rows]
        src = torch.where(patch, vfill[:, None], src)
    return ffor_pack(src, base if rows is None else base[rows], bw)


def _word_index(offsets, bw, lanes):
    return offsets[:, None] + torch.arange(lanes * bw, device=offsets.device)


@tracing.kernel
def ffor_pack_f64(values, base, bw, *, exc=None, fill=None, rows=None,
                  out=None, offsets=None, checked=True):
    """K10.  values: int64 [N, 1024]; base: int64 [N], each vector's FOR
    base; bw: the bucket's bit width, 1..64; exc (bool [N, 1024]) with
    fill (int64 [N]): exception slots read the vector's fill before the
    subtract.  rows: int64 [m], the vectors of the bucket (all N when
    None).  Returns the [m, 16 * bw] int64 words; or, with ``out`` (flat
    int64) and ``offsets`` (int64 [m]), writes row r's words from
    ``out[offsets[r]]`` and returns ``out``.  ``checked=False`` skips the
    synchronising reads of the range of ``rows`` and ``offsets``, for
    callers that built them in range (a loop step)."""
    return _pack(values, base, bw, exc, fill, rows, out, offsets,
                 torch.int64, checked)


@tracing.kernel
def ffor_pack_f32(values, base, bw, *, exc=None, fill=None, rows=None,
                  out=None, offsets=None, checked=True):
    """K13, the 32-bit twin of K10: values, base, fill and out int32; bw
    1..32; 32 * bw words a vector (rows and offsets stay int64)."""
    return _pack(values, base, bw, exc, fill, rows, out, offsets,
                 torch.int32, checked)


def _pack(values, base, bw, exc, fill, rows, out, offsets, word, checked):
    S, name = _WORDS[word]
    lanes = VECTOR_SIZE // S
    n = values.shape[0]
    device = values.device
    _check("values", values, word, (n, VECTOR_SIZE), device)
    _check("base", base, word, (n,), device)
    if (exc is None) != (fill is None):
        raise ValueError("exc and fill go together")
    if exc is not None:
        _check("exc", exc, torch.bool, (n, VECTOR_SIZE), device)
        _check("fill", fill, word, (n,), device)
    m = n if rows is None else rows.shape[0]
    if rows is not None:
        _check("rows", rows, torch.int64, (m,), device)
        if m and checked:
            with tracing.span("alp.fetch.ffor.rows"):
                lo, hi = (int(x) for x in torch.aminmax(rows))
            if lo < 0 or hi >= n:
                raise ValueError("rows reach outside values")
    if (out is None) != (offsets is None):
        raise ValueError("out and offsets go together")
    if not 1 <= bw <= S:
        raise ValueError(f"bit width {bw} out of range 1..{S}")
    if out is None:
        out = torch.empty((m, lanes * bw), dtype=word, device=device)
    else:
        if out.dim() != 1:
            raise ValueError("out must be flat")
        _check("out", out, word, out.shape, device)
        _check("offsets", offsets, torch.int64, (m,), device)
        if m and checked:
            with tracing.span("alp.fetch.ffor.offsets"):
                lo, hi = (int(x) for x in torch.aminmax(offsets))
            if lo < 0 or hi + lanes * bw > out.numel():
                raise ValueError("offsets reach outside out")
    if _device_kind(values) == "cpu":
        words = ffor_plain(values, base, bw, exc, fill, rows)
        if offsets is None:
            out.copy_(words)
        else:
            out[_word_index(offsets, bw, lanes)] = words
        return out
    _launch(name, device, _ptr(values), _ptr(rows), _ptr(exc), _ptr(fill),
            _ptr(base), bw, _ptr(offsets), m, _ptr(out))
    LAUNCHES[name] += 1
    return out


@tracing.kernel
def unffor(packed, bw, base) -> torch.Tensor:
    """K22: unFFOR of a bucket of vectors that share the bit width ``bw``.
    packed: int64 [n, 16 * bw] (64-bit elements) or int32 [n, 32 * bw]
    (32-bit elements) FastLanes words; base: [n] of the same dtype.
    Returns [n, 1024] integers of that dtype, the base added with wrap
    (at bw 0 the base broadcast).  The plain version is
    ``ops.fastlanes.unffor_unpack``."""
    S = word_bits(packed.dtype)
    if S not in (32, 64):
        raise TypeError("unffor takes int64 or int32 words")
    n = packed.shape[0]
    device = packed.device
    if not 0 <= bw <= S:
        raise ValueError(f"bit width {bw} out of range 0..{S}")
    _check("packed", packed, packed.dtype, (n, bw * (VECTOR_SIZE // S)),
           device)
    _check("base", base, packed.dtype, (n,), device)
    if _device_kind(packed) == "cpu":
        return unffor_unpack(packed, base, bw)
    out = torch.empty((n, VECTOR_SIZE), dtype=packed.dtype, device=device)
    _launch(f"unffor_f{S}", device, _ptr(packed), bw, _ptr(base), n,
            _ptr(out))
    LAUNCHES["unffor"] += 1
    return out
