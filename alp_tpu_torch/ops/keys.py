"""IEEE-754 total-order keys of bit patterns, on tensors.

The predicate and order queries compare values by their total-order key:
for bits ``b`` (-0.0 first mapped to +0.0) the key is ``~b`` for a
negative value and ``b | sign`` otherwise, so that unsigned order on keys
is -NaN < -Inf < finite < +Inf < +NaN with the two zeros equal
(``alp_tpu/engine.py`` ``_float_key``, ``_masked_keys``).  PyTorch has no
unsigned 64-bit compare, so the plain versions work on *biased* keys,
``key ^ sign`` read as a signed integer, which are in the same order.
Keys and biased keys live in the bit patterns' own signed dtype (int64 for
f64, int32 for f32).
"""

from __future__ import annotations

import torch


def sign_bit(dtype: torch.dtype) -> int:
    """The sign bit of ``dtype`` as a signed integer (its minimum)."""
    return torch.iinfo(dtype).min


def biased_keys(bits: torch.Tensor) -> torch.Tensor:
    """Signed integers in the total order of the values ``bits``: ``b`` for
    a non-negative value, ``b ^ max`` for a negative one, -0.0 as +0.0."""
    sign = sign_bit(bits.dtype)
    b = torch.where(bits == sign, torch.zeros_like(bits), bits)
    return torch.where(b < 0, b ^ torch.iinfo(bits.dtype).max, b)


def bias(keys: torch.Tensor) -> torch.Tensor:
    """Unsigned keys (held in a signed dtype) -> biased keys, and back."""
    return keys ^ sign_bit(keys.dtype)


def _signed_word(key: int, dtype: torch.dtype) -> int:
    """An unsigned key as the signed integer of the same bits."""
    bits = torch.iinfo(dtype).bits
    key &= (1 << bits) - 1
    return key - (1 << bits) if key >> (bits - 1) else key


def in_key_range(bits: torch.Tensor, klo: int, khi: int) -> torch.Tensor:
    """``klo <= key(bits) <= khi``, with ``klo``/``khi`` unsigned keys."""
    b = biased_keys(bits)
    sign = sign_bit(bits.dtype)
    lo = _signed_word(klo, bits.dtype) ^ sign
    hi = _signed_word(khi, bits.dtype) ^ sign
    return (b >= lo) & (b <= hi)
