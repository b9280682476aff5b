"""ALP_RD split of value bit patterns on tensors (plain PyTorch).

Counterpart of ``alp_tpu/ops/rd.py:rd_encode_vectors`` (reference
include/alp/rd.hpp:109-147), vectors batched as ``[n, 1024]``.  Each bit
pattern splits into its low ``right_bw`` bits and its left part; the left
part is looked up in the rowgroup's dictionary (at most 8 entries, padded).
Left parts missing from it become exceptions: their index is the
dictionary size and the caller stores the raw left part.
"""

from __future__ import annotations

import torch

from .. import tracing
from .fastlanes import low_mask, narrow, srl, widen, word_bits


def rd_encode_vectors(bits: torch.Tensor, right_bw: torch.Tensor,
                      left_dict: torch.Tensor, dict_size: torch.Tensor):
    """bits: [n, 1024] int64/int32 patterns; right_bw, dict_size: [n];
    left_dict: [n, 8] dictionary entries (u16 values, any integer dtype).

    Returns (right [n, 1024] in the patterns' dtype, left index
    [n, 1024] int16, exception mask [n, 1024] bool, raw left part
    [n, 1024] int64 in 0..0xFFFF)."""
    S = word_bits(bits.dtype)
    b = widen(bits, S)
    right = torch.empty_like(b)
    left_raw = torch.empty_like(b)
    # the widths' fetch and each mask's nonzero wait on the device
    with tracing.span("alp.fetch.rd.split"):
        for rbw in torch.unique(right_bw).tolist():
            sel = right_bw == rbw
            right[sel] = b[sel] & low_mask(rbw)
            left_raw[sel] = srl(b[sel], rbw) & 0xFFFF
    entries = widen(left_dict, 16)
    # only entries below the rowgroup's dictionary size may match: a left
    # part equal to the 0xFFFF padding is an exception, as in rd.hpp:127-144
    valid = (torch.arange(entries.shape[1], device=bits.device)[None, :]
             < dict_size.to(torch.int64)[:, None])
    matches = (left_raw[:, :, None] == entries[:, None, :]) & valid[:, None]
    in_dict = matches.any(dim=2)
    idx = matches.to(torch.int8).argmax(dim=2)
    idx = torch.where(in_dict, idx, dict_size.to(torch.int64)[:, None])
    return narrow(right, S), idx.to(torch.int16), ~in_dict, left_raw
