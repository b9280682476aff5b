"""TPC-H LINEITEM's measures (the formulas of ``generators/tpch_lineitem.py``)
drawn by rows, for cells on several cards in the benchmark's tests.

``rows(name, config, lo, hi, seed_of, device)`` gives rows [lo, hi) of a
column.  Each block of ``BLOCK`` rows draws from a generator seeded by the
draw's name and the block's index, and a block is always drawn whole, so
a row's value depends on the seed and its index alone, never on how the
rows are split over ranks.  ``column`` is rows [0, n), for a cell on one
card.

The configuration's ``fault`` plants a fault on every rank but rank 0
(whose rows start at 0): ``raise`` raises here, in set-up; ``hang``
sleeps here until the run's deadline has long passed.
"""

import time

import torch

BLOCK = 1 << 20
HANG_S = 3600.0


def _draw(seed_of, name: str, least: int, most: int, lo: int, hi: int,
          device) -> torch.Tensor:
    """int64 draws in [least, most] of rows [lo, hi)."""
    out = torch.empty(hi - lo, dtype=torch.int64, device=device)
    for b in range(lo // BLOCK, -(-hi // BLOCK)):
        g = torch.Generator(device=device)
        g.manual_seed(seed_of(f"{name}.{b}"))
        block = torch.randint(least, most + 1, (BLOCK,), generator=g,
                              device=device, dtype=torch.int64)
        s, e = max(lo, b * BLOCK), min(hi, (b + 1) * BLOCK)
        out[s - lo:e - lo] = block[s - b * BLOCK:e - b * BLOCK]
    return out


def rows(name: str, config: dict, lo: int, hi: int, seed_of,
         device) -> torch.Tensor:
    """float64 [hi - lo] values of rows [lo, hi) of column ``name``."""
    fault = (config.get("fault") or {}).get("kind")
    if lo > 0 and fault == "raise":
        raise RuntimeError(f"planted fault: rows [{lo}, {hi}) raise")
    if lo > 0 and fault == "hang":
        time.sleep(HANG_S)
    if name == "l_quantity":
        return _draw(seed_of, "l_quantity", 1, 50, lo, hi, device).double()
    if name == "l_extendedprice":
        qty = _draw(seed_of, "l_quantity", 1, 50, lo, hi, device)
        key = _draw(seed_of, "l_partkey", 1,
                    int(config["scale_factor"]) * 200_000, lo, hi, device)
        cents = 90000 + (key // 10) % 20001 + 100 * (key % 1000)
        return (cents * qty).double() / 100
    if name == "l_discount":
        return _draw(seed_of, "l_discount", 0, 10, lo, hi,
                     device).double() / 100
    if name == "l_tax":
        return _draw(seed_of, "l_tax", 0, 8, lo, hi, device).double() / 100
    raise KeyError(f"LINEITEM has no generated column {name!r}")


def column(name: str, config: dict, n: int, seed_of, device) -> torch.Tensor:
    return rows(name, config, 0, n, seed_of, device)
