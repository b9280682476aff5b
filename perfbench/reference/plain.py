"""The plain reference: the answers of each query, from the raw values.

Plain PyTorch and numpy, working from the values the benchmark generated
and never from anything the program made.  It runs on the values'
device, in blocks of ``BLOCK`` values, so that a 600 M-value column fits
beside its temporaries.  Values are float64 or float32; float32 values
are widened to float64 block by block, which is exact.

* ``exact_sum``: the correctly rounded sum of the values, as
  ``math.fsum`` gives it: each finite value is its signed integer
  significand times 2^(e - 1075) (e the biased exponent, at least 1);
  the significands of each exponent are added in int64, split in 27- and
  26-bit halves so that no sum can overflow below 2^31 values, and the
  2048 per-exponent totals are joined as a Python integer and rounded
  once.
* ``exact_mean``: that integer over n, rounded once.
* ``count_between``, ``topk``: by comparison.
* ``quantiles``: numpy's ``linear`` method on the sorted column, its
  interpolation in the column's dtype.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

BLOCK = 1 << 26
_LOW = 26
_SCALE = 1074          # sums are integers in units of 2^-1074


def dtype(values: torch.Tensor) -> np.dtype:
    """The numpy dtype of a tensor's values."""
    return torch.empty(0, dtype=values.dtype).numpy().dtype


def _blocks(values: torch.Tensor):
    flat = values.reshape(-1)
    for s in range(0, flat.numel(), BLOCK):
        yield flat[s:s + BLOCK]


def exact_total(values: torch.Tensor, mask=None) -> tuple:
    """(the exact sum of the finite ``values`` [where ``mask``] in units
    of 2^-1074, a Python int; NaN count; +Inf count; -Inf count)."""
    if values.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"the reference sums no {values.dtype} values")
    dev = values.device
    hi = torch.zeros(2048, dtype=torch.int64, device=dev)
    lo = torch.zeros(2048, dtype=torch.int64, device=dev)
    special = torch.zeros(3, dtype=torch.int64, device=dev)
    flat_mask = None if mask is None else mask.reshape(-1)
    start = 0
    for block in _blocks(values):
        bits = block.double().view(torch.int64)
        field = (bits >> 52) & 0x7FF
        frac = bits & ((1 << 52) - 1)
        keep = field != 0x7FF
        if flat_mask is not None:
            sel = flat_mask[start:start + block.numel()]
            keep &= sel
        else:
            sel = None
        sig = torch.where(field == 0, frac, frac | (1 << 52))
        sig = torch.where(bits < 0, -sig, sig)
        sig = torch.where(keep, sig, torch.zeros_like(sig))
        e = torch.clamp(field, min=1)
        hi.scatter_add_(0, e, sig >> _LOW)
        lo.scatter_add_(0, e, sig & ((1 << _LOW) - 1))
        odd = field == 0x7FF
        if sel is not None:
            odd &= sel
        nan = odd & (frac != 0)
        inf = odd & (frac == 0)
        special += torch.stack([nan.sum(), (inf & (bits >= 0)).sum(),
                                (inf & (bits < 0)).sum()])
        start += block.numel()
    hi_l, lo_l = hi.tolist(), lo.tolist()
    total = 0
    for e in range(2048):
        if hi_l[e] or lo_l[e]:
            total += ((hi_l[e] << _LOW) + lo_l[e]) << (e - 1)
    nan, pinf, ninf = special.tolist()
    return total, nan, pinf, ninf


def _special(nan: int, pinf: int, ninf: int):
    if nan or (pinf and ninf):
        return math.nan
    if pinf:
        return math.inf
    if ninf:
        return -math.inf
    return None


def exact_sum(values: torch.Tensor, mask=None) -> float:
    """SUM, correctly rounded (``math.fsum``'s answer)."""
    total, *spec = exact_total(values, mask)
    odd = _special(*spec)
    if odd is not None:
        return odd
    return float(Fraction(total, 1 << _SCALE))


def exact_mean(values: torch.Tensor) -> float:
    """MEAN: the exact sum over n, rounded once."""
    n = values.numel()
    total, *spec = exact_total(values)
    odd = _special(*spec)
    if odd is not None:
        return odd
    return float(Fraction(total, n << _SCALE))


def between(values: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """The mask lo <= v <= hi (the values are compared as they are)."""
    return (values >= lo) & (values <= hi)


def count_between(values: torch.Tensor, lo: float, hi: float) -> int:
    return sum(int(between(b, lo, hi).sum()) for b in _blocks(values))


def sum_between(values: torch.Tensor, lo: float, hi: float) -> float:
    return exact_sum(values, between(values, lo, hi))


def topk(values: torch.Tensor, k: int, largest: bool = True) -> np.ndarray:
    """The k largest (or smallest) values, best first."""
    got = torch.topk(values.reshape(-1), k, largest=largest, sorted=True)
    return got.values.cpu().numpy()


def quantiles(sorted_values: torch.Tensor, qs) -> np.ndarray:
    """numpy's ``np.quantile(x, qs)`` (method ``linear``) of a column whose
    values, sorted ascending, are ``sorted_values``: h = (n - 1) q in
    float64, the neighbours at floor(h) and floor(h) + 1, and numpy's
    ``_lerp`` operation for operation in the column's dtype (none at a
    whole h).  A NaN in the column gives NaN."""
    n = sorted_values.numel()
    dt = dtype(sorted_values).type
    out = np.empty(len(qs), dt)
    if bool(torch.isnan(sorted_values[-1:]).any()):
        out[:] = np.nan
        return out
    for j, q in enumerate(qs):
        h = np.float64(n - 1) * np.float64(q)
        i = int(np.floor(h))
        t = h - np.float64(i)
        a = dt(sorted_values[i].item())
        r = a
        if t > 0:
            b = dt(sorted_values[min(i + 1, n - 1)].item())
            diff = b - a
            r = a + diff * dt(t)
            if t >= 0.5:
                r = b - diff * dt(np.float64(1) - t)
        out[j] = r
    return out


def sort(values: torch.Tensor) -> torch.Tensor:
    return torch.sort(values.reshape(-1)).values


def quantiles_of(values: torch.Tensor, qs, cache: dict) -> np.ndarray:
    """``quantiles`` of ``values``, sorting them once a ``cache``."""
    if "sorted" not in cache:
        cache["sorted"] = sort(values)
    return quantiles(cache["sorted"], qs)
