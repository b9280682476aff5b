"""ALP planning primitives on tensors (plain PyTorch).

Counterpart of the planning half of ``alp_tpu/ops/alp.py``:
``bit_width_of``, ``ef_pairs_arrays``, ``first_level_vote`` and
``accept_scan``.  They turn the per-pair estimates of the scorer
(``kernels.score``, K11) into the reference planner's choices
(encoder.hpp:139-305; the host engine ``native/alpcore.cpp``), tie-breaks
included, so device planning picks what host compress picks:

* the first level votes each sampled vector's best pair, the
  lexicographic min of (est, -e, -f) over the pairs with at least two
  non-exceptions and est <= worst ((0, 0) when there is none), then keeps
  the top k pairs by (count, e, f); a rowgroup whose best estimate reaches
  ``rd_size_threshold_limit`` takes ALP_RD;
* the second level scans each vector's k candidates in order, accepting
  the first and every strict improvement, and stops after
  ``SAMPLING_EARLY_EXIT_THRESHOLD`` non-improvements in a row.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from .fastlanes import srl


def bit_width_of(delta: torch.Tensor) -> torch.Tensor:
    """int32 bit length of int64 or int32 bit patterns read as unsigned
    of their own width (0 for 0): an int32 delta is not sign-extended."""
    x = delta.to(torch.int64)
    if delta.dtype == torch.int32:
        x = x & 0xFFFFFFFF
    bw = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for s in (32, 16, 8, 4, 2, 1):
        big = srl(x, s) != 0
        bw += torch.where(big, s, 0).to(torch.int32)
        x = torch.where(big, srl(x, s), x)
    return bw + (x != 0).to(torch.int32)


def ef_pairs_arrays(tc) -> tuple:
    """(e, f) candidates in find_top_k_combinations' order (e from
    max_exponent down, f from e down), as two int32 arrays."""
    pairs = [(e, f) for e in range(tc.max_exponent, -1, -1)
             for f in range(e, -1, -1)]
    return (np.array([p[0] for p in pairs], np.int32),
            np.array([p[1] for p in pairs], np.int32))


@functools.cache
def _pair_columns(f64: bool, device: str) -> tuple:
    """The pairs' e and f as int64 tensors, uploaded once a device (an
    upload syncs with the device)."""
    es, fs = ef_pairs_arrays(C.DOUBLE if f64 else C.FLOAT)
    return (torch.from_numpy(es).to(device, torch.int64),
            torch.from_numpy(fs).to(device, torch.int64))


def first_level_vote(est: torch.Tensor, non_exc: torch.Tensor, S: int, tc):
    """The vote and rank of find_top_k_combinations over the estimates
    ``est`` and non-exception counts ``non_exc`` [R, V, P] of R rowgroups,
    V sampled vectors of S samples each, P pairs in ``ef_pairs_arrays``
    order.  Returns (combos int32 [R, 5, 2] (e, f), zero past k; k int32
    [R]; is_rd bool [R])."""
    dev = est.device
    es, fs = _pair_columns(tc is C.DOUBLE, str(dev))
    P = es.numel()
    est = est.to(torch.int64)
    worst = (S * (tc.exception_size + C.EXCEPTION_POSITION_SIZE)
             + S * tc.exception_size)
    valid = (non_exc >= 2) & (est <= worst)
    # each vector's winner: the lexicographic min of (est, -e, -f)
    me = tc.max_exponent
    key = (est << 16) | ((me - es) << 8) | (me - fs)
    win = torch.where(valid, key, torch.iinfo(torch.int64).max).argmin(-1)
    any_valid = valid.any(dim=-1)
    win = torch.where(any_valid, win, P - 1)          # pair (0, 0)
    est_win = torch.gather(est, -1, win[..., None])[..., 0]
    best = torch.where(any_valid, est_win, worst).amin(dim=1)
    is_rd = best >= tc.rd_size_threshold_limit
    counts = torch.zeros(est.shape[0], P, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, win, torch.ones_like(win))
    rank = torch.where(counts > 0, (counts << 16) | (es << 8) | fs, -1)
    top = rank.topk(C.MAX_K_COMBINATIONS, dim=1).indices
    k = (counts > 0).sum(dim=1).clamp(max=C.MAX_K_COMBINATIONS)
    live = (torch.arange(C.MAX_K_COMBINATIONS, device=dev)[None, :]
            < k[:, None])
    combos = torch.stack([es[top], fs[top]], dim=-1)
    combos = torch.where(live[..., None], combos, 0)
    return combos.to(torch.int32), k.to(torch.int32), is_rd


def accept_scan(est: torch.Tensor, combos: torch.Tensor,
                k_count: torch.Tensor) -> tuple:
    """The second level's accept / early-exit rule over the estimates
    ``est`` [n, 5] of each vector's candidates ``combos`` [n, 5, 2] (e, f),
    of which the first ``k_count`` [n] are real.  Returns (fac, exp) int32
    [n]; a vector with k_count 0 gets (0, 0)."""
    n = est.shape[0]
    dev = est.device
    found_e = torch.zeros(n, dtype=torch.int32, device=dev)
    found_f = torch.zeros(n, dtype=torch.int32, device=dev)
    best = torch.zeros(n, dtype=torch.int64, device=dev)
    worse = torch.zeros(n, dtype=torch.int32, device=dev)
    stopped = torch.zeros(n, dtype=torch.bool, device=dev)
    est = est.to(torch.int64)
    combos = combos.to(torch.int32)
    for k in range(C.MAX_K_COMBINATIONS):
        active = ~stopped & (k < k_count)
        improve = est[:, k] < best
        accept = active & (improve if k else torch.ones_like(improve))
        if k:
            worse = torch.where(active & ~improve, worse + 1,
                                torch.where(active & improve, 0, worse))
        stopped |= active & (worse >= C.SAMPLING_EARLY_EXIT_THRESHOLD)
        found_e = torch.where(accept, combos[:, k, 0], found_e)
        found_f = torch.where(accept, combos[:, k, 1], found_f)
        best = torch.where(accept, est[:, k], best)
    return found_f, found_e
