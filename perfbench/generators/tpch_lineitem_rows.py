"""TPC-H LINEITEM's numeric measures drawn by rows, for a cell on several
cards: the formulas of ``generators/tpch_lineitem.py`` (TPC-H v3, clause
4.2.3), each rank drawing only its own rows on its own card.

* L_QUANTITY random [1 .. 50];
* L_PARTKEY random [1 .. SF * 200,000] (drawn uniformly);
* P_RETAILPRICE = (90000 + ((partkey / 10) modulo 20001) + 100 *
  (partkey modulo 1000)) / 100;
* L_EXTENDEDPRICE = L_QUANTITY * P_RETAILPRICE;
* L_DISCOUNT random [0.00 .. 0.10], L_TAX random [0.00 .. 0.08].

The decimals are made exactly in integer cents and held as the float64
nearest to each (cents / 100, one correctly rounded division).

``rows(name, config, lo, hi, seed_of, device)`` gives rows [lo, hi) of a
column.  The rows are drawn in blocks of ``BLOCK``: each block of each
draw has a generator of its own, seeded from the run's seed, the draw's
name and the block's index, and is always drawn whole.  So a row's value
depends on the seed and its index alone, never on how the rows are split
over ranks, and L_EXTENDEDPRICE draws the same quantities as L_QUANTITY.
Each block is turned into values at once, so a share takes its output
and one block's draws of memory.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 20
COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")


def _draw(seed_of, name: str, block: int, least: int, most: int,
          device) -> torch.Tensor:
    """int64 [BLOCK] draws in [least, most] of block ``block``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(f"{name}.{block}"))
    return torch.randint(least, most + 1, (BLOCK,), generator=g,
                         device=device, dtype=torch.int64)


def _block(name: str, config: dict, block: int, seed_of,
           device) -> torch.Tensor:
    """float64 [BLOCK] values of block ``block`` of column ``name``."""
    if name == "l_quantity":
        return _draw(seed_of, "l_quantity", block, 1, 50, device).double()
    if name == "l_extendedprice":
        qty = _draw(seed_of, "l_quantity", block, 1, 50, device)
        key = _draw(seed_of, "l_partkey", block, 1,
                    int(config["scale_factor"]) * 200_000, device)
        cents = 90000 + (key // 10) % 20001 + 100 * (key % 1000)
        return (cents * qty).double() / 100
    if name == "l_discount":
        return _draw(seed_of, "l_discount", block, 0, 10,
                     device).double() / 100
    if name == "l_tax":
        return _draw(seed_of, "l_tax", block, 0, 8, device).double() / 100
    raise KeyError(f"LINEITEM has no generated column {name!r}")


def rows(name: str, config: dict, lo: int, hi: int, seed_of,
         device) -> torch.Tensor:
    """float64 [hi - lo] values of rows [lo, hi) of column ``name`` on
    ``device``; ``seed_of`` maps a draw's name to its seed."""
    out = torch.empty(hi - lo, dtype=torch.float64, device=device)
    for b in range(lo // BLOCK, -(-hi // BLOCK)):
        s, e = max(lo, b * BLOCK), min(hi, (b + 1) * BLOCK)
        out[s - lo:e - lo] = _block(name, config, b, seed_of,
                                    device)[s - b * BLOCK:e - b * BLOCK]
    return out


def column(name: str, config: dict, n: int, seed_of, device) -> torch.Tensor:
    """Rows [0, n): the whole column, for a cell on one card."""
    return rows(name, config, 0, n, seed_of, device)
