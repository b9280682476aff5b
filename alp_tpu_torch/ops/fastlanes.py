"""FastLanes FFOR bit-packing on tensors (plain PyTorch).

Counterpart of ``alp_tpu/ops/fastlanes.py`` with the semantics of
``alp_tpu/oracle/fastlanes.py``.  The layout is the reference's
interleaved one (reference src/fastlanes_generated_ffor.cpp; SURVEY.md
§2.1): for S-bit words a 1024-value vector has L = 1024 / S lanes, value
``k`` lives in lane ``k % L`` at slot ``k // L``, each lane packs its S
values slot-major and LSB-first into ``bw`` words, and word ``w`` of lane
``i`` is stored at ``w * L + i``.  FFOR subtracts a per-vector base
(wrapping) before masking to ``bw`` bits; unFFOR adds it back.  ``bw == 0``
packs to no words and unpacks to a broadcast of the base.

Words travel as signed tensors of their width (int16 / int32 / int64)
holding the bit patterns, since PyTorch lacks arithmetic on its unsigned
types.  The arithmetic runs in int64: shifts wrap there, and right shifts
of 64-bit words are made logical by masking.  This is the unFFOR that the
decode kernels' plain versions use.
"""

from __future__ import annotations

import numpy as np
import torch

VECTOR_SIZE = 1024
_WORD = {16: torch.int16, 32: torch.int32, 64: torch.int64}


def word_bits(dtype: torch.dtype) -> int:
    """S, the word width of a packed tensor's dtype."""
    for bits, dt in _WORD.items():
        if dt == dtype:
            return bits
    raise TypeError(f"packed words must be int16/int32/int64, got {dtype}")


def low_mask(bits: int) -> int:
    """The int64 bit pattern of ``bits`` ones (``bits`` in 0..64)."""
    return -1 if bits >= 64 else (1 << bits) - 1


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by ``s`` in 0..63."""
    return x if s == 0 else (x >> s) & low_mask(64 - s)


def words_from_numpy(a: np.ndarray) -> torch.Tensor:
    """NumPy words or bit patterns -> a tensor of the signed type of their
    width, sharing memory (PyTorch lacks arithmetic on unsigned types)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(f"i{a.dtype.itemsize}"))


def widen(x: torch.Tensor, bits: int) -> torch.Tensor:
    """S-bit patterns -> zero-extended int64."""
    x = x.to(torch.int64)
    return x if bits == 64 else x & low_mask(bits)


def narrow(x: torch.Tensor, bits: int) -> torch.Tensor:
    """int64 -> the low S bits as the S-bit signed dtype (wrapping)."""
    if bits < 64:
        x = x & low_mask(bits)
        x = torch.where(x >= (1 << (bits - 1)), x - (1 << bits), x)
    return x.to(_WORD[bits])


def ffor_pack(values: torch.Tensor, base: torch.Tensor,
              bw: int) -> torch.Tensor:
    """FOR + bit-pack [n, 1024] values -> [n, bw * L] words of the values'
    width.  ``base``: [n] frame of reference, subtracted with wrap."""
    S = word_bits(values.dtype)
    L = VECTOR_SIZE // S
    n = values.shape[0]
    if not 0 <= bw <= S:
        raise ValueError(f"bit width {bw} out of range for {S}-bit words")
    words = torch.zeros((n, bw, L), dtype=torch.int64, device=values.device)
    if bw == 0:
        return words.reshape(n, 0).to(values.dtype)
    delta = widen(values, S) - widen(base, S)[:, None]
    delta = (delta & low_mask(bw)).reshape(n, S, L)
    for v in range(S):
        w0, s0 = divmod(v * bw, S)
        words[:, w0] |= delta[:, v] << s0
        if s0 + bw > S:
            words[:, w0 + 1] |= srl(delta[:, v], S - s0)
    return narrow(words, S).reshape(n, bw * L)


def unffor_unpack(packed: torch.Tensor, base: torch.Tensor,
                  bw: int) -> torch.Tensor:
    """Inverse of :func:`ffor_pack`: [n, bw * L] words -> [n, 1024] values
    of the words' width, the base added back with wrap."""
    S = word_bits(packed.dtype)
    L = VECTOR_SIZE // S
    n = packed.shape[0]
    if not 0 <= bw <= S:
        raise ValueError(f"bit width {bw} out of range for {S}-bit words")
    if packed.shape[1] != bw * L:
        raise ValueError(f"expected {bw * L} words per vector, "
                         f"got {packed.shape[1]}")
    out = torch.zeros((n, S, L), dtype=torch.int64, device=packed.device)
    words = widen(packed, S).reshape(n, bw, L)
    for v in range(S if bw else 0):
        w0, s0 = divmod(v * bw, S)
        val = srl(words[:, w0], s0)
        if s0 + bw > S:
            val = val | (words[:, w0 + 1] << (S - s0))
        out[:, v] = val & low_mask(bw)
    out = out.reshape(n, VECTOR_SIZE) + widen(base, S)[:, None]
    return narrow(out, S)
