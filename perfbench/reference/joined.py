"""The plain reference of a cell on several cards, from each rank's share:
exact parts that join as integers, and the answer from the joined parts.

A share's part of a SUM is ``plain.exact_total`` of its values (the exact
sum in units of 2^-1074, a Python int, and the NaN, +Inf and -Inf
counts) with its count of values; the parts add up exactly, and the
answer is rounded once from their sum, as ``plain.exact_sum`` and
``plain.exact_mean`` round the total of a whole column.
"""

from __future__ import annotations

from fractions import Fraction

from . import plain


def total_part(values, mask=None, cache=None) -> tuple:
    """(exact total, NaN, +Inf, -Inf, values) of a share, its total kept
    in ``cache`` when no ``mask`` is given."""
    if mask is None and cache is not None:
        if "total" not in cache:
            cache["total"] = plain.exact_total(values)
        return (*cache["total"], values.numel())
    return (*plain.exact_total(values, mask), values.numel())


def joined(parts: list) -> tuple:
    """The parts added up: (exact total, NaN, +Inf, -Inf, values)."""
    return tuple(sum(p[i] for p in parts) for i in range(5))


def sum_of(parts: list) -> float:
    """SUM of the joined shares, correctly rounded."""
    total, nan, pinf, ninf, _ = joined(parts)
    odd = plain._special(nan, pinf, ninf)
    return odd if odd is not None else float(Fraction(total,
                                                      1 << plain._SCALE))


def mean_of(parts: list) -> float:
    """MEAN of the joined shares: their exact sum over their count of
    values, rounded once."""
    total, nan, pinf, ninf, n = joined(parts)
    odd = plain._special(nan, pinf, ninf)
    return odd if odd is not None else float(Fraction(total,
                                                      n << plain._SCALE))
