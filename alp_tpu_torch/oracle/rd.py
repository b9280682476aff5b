"""ALP_RD ("real doubles") dictionary search, NumPy only.

Reference include/alp/rd.hpp:33-104, 180-185; the JAX package's
counterpart is ``alp_tpu/oracle/rd.py:rd_encoder_init``.  Each value's bit
pattern is cut into a left part (top ``cut`` bits, coded against a
dictionary of at most 8 entries built from the rowgroup's first-level
sample) and a right part stored raw.  This module picks the cut and the
dictionary; the split itself is ``ops.rd``.

The reference sorts left parts by count over an unordered_map's iteration
order, so the order of tied counts is implementation-defined there.  Ties
break by the smaller left value, as in the JAX package, so the port's blobs
equal its blobs byte for byte.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .. import constants as C
from ..constants import TypeConstants


@dataclasses.dataclass
class RdState:
    """The ALP_RD part of the reference's ``alp::state``."""
    sampled_values_n: int = 0
    right_bit_width: int = 0
    left_bit_width: int = 0
    left_parts_dict: np.ndarray | None = None   # u16[actual_dictionary_size]
    actual_dictionary_size: int = 0


def first_level_sample(data: np.ndarray, offset: int) -> np.ndarray:
    """sampler::first_level_sample over the rowgroup at ``offset``: every
    ROWGROUP_SAMPLES_JUMP-th vector, 32 equidistant values of each; a tail
    vector shorter than 32 values is skipped unless nothing was sampled."""
    data_size = len(data)
    portion = min(C.ROWGROUP_SIZE, data_size - offset)
    out = []
    data_idx = offset
    for vector_idx in range(math.ceil(portion / C.VECTOR_SIZE)):
        cur_n = min(data_size - data_idx, C.VECTOR_SIZE)
        take = vector_idx % C.ROWGROUP_SAMPLES_JUMP == 0 and not (
            cur_n < C.SAMPLES_PER_VECTOR and out)
        if take:
            inc = max(1, math.ceil(cur_n / C.SAMPLES_PER_VECTOR))
            out.append(data[data_idx:data_idx + cur_n:inc])
        data_idx += cur_n
    return np.concatenate(out) if out else data[:0]


def _dictionary(sample_bits: np.ndarray, right_bw: int, n_samples: int):
    """(estimated bits per value, dictionary, left bit width) at one cut
    (build_left_parts_dictionary, rd.hpp:33-87)."""
    lefts, counts = np.unique(sample_bits >> sample_bits.dtype.type(right_bw),
                              return_counts=True)
    order = np.lexsort((lefts, -counts))     # count desc, then value asc
    lefts, counts = lefts[order], counts[order]
    size = min(C.MAX_RD_DICTIONARY_SIZE, len(lefts))
    left_bw = max(1, math.ceil(math.log2(size)) if size else 0)
    exceptions = int(counts[C.MAX_RD_DICTIONARY_SIZE:].sum())
    est = (right_bw + left_bw + exceptions * (C.RD_EXCEPTION_POSITION_SIZE
                                              + C.RD_EXCEPTION_SIZE)
           / n_samples)
    return est, lefts[:size].astype(np.uint16), left_bw


def rd_encoder_init(data: np.ndarray, offset: int,
                    tc: TypeConstants) -> RdState:
    """rd_encoder::init (rd.hpp:180-185): sample the rowgroup, then
    :func:`rd_state_from_sample`."""
    return rd_state_from_sample(first_level_sample(data, offset), tc)


def rd_state_from_sample(sample: np.ndarray, tc: TypeConstants) -> RdState:
    """The ALP_RD state of a rowgroup from its first-level sample: sweep
    the cut over [1, CUTTING_LIMIT] and keep the cheapest dictionary (the
    first of equal estimates, find_best_dictionary, rd.hpp:89-104)."""
    bits = sample.view(tc.ut)
    best = None
    for cut in range(1, C.CUTTING_LIMIT + 1):
        right_bw = tc.exact_type_bit_size - cut
        est = _dictionary(bits, right_bw, len(sample))[0]
        if best is None or est < best[0]:
            best = (est, right_bw)
    _, lefts, left_bw = _dictionary(bits, best[1], len(sample))
    return RdState(sampled_values_n=len(sample), right_bit_width=best[1],
                   left_bit_width=left_bw, left_parts_dict=lefts,
                   actual_dictionary_size=len(lefts))
