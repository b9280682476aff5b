"""TPC-H LINEITEM's numeric measures, by the formulas of the TPC-H v3
specification, clause 4.2.3, generated on the device from the seed.

* L_QUANTITY random [1 .. 50];
* L_PARTKEY random [1 .. SF * 200,000] (drawn uniformly);
* P_RETAILPRICE = (90000 + ((partkey / 10) modulo 20001) + 100 *
  (partkey modulo 1000)) / 100;
* L_EXTENDEDPRICE = L_QUANTITY * P_RETAILPRICE;
* L_DISCOUNT random [0.00 .. 0.10], L_TAX random [0.00 .. 0.08].

The decimals are made exactly in integer cents and held as the float64
nearest to each (cents / 100, one correctly rounded division), as a
column store holds DECIMAL(15,2) values loaded as doubles.  Each draw
has a generator of its own, seeded from the run's seed and its name, so
L_EXTENDEDPRICE draws the same quantities as L_QUANTITY.
"""

from __future__ import annotations

import torch

COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")


def _draw(seed_of, name: str, lo: int, hi: int, n: int, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(name))
    return torch.randint(lo, hi + 1, (n,), generator=g, device=device,
                         dtype=torch.int64)


def column(name: str, config: dict, n: int, seed_of, device) -> torch.Tensor:
    """float64 [n] values of column ``name`` on ``device``; ``seed_of``
    maps a draw's name to its seed."""
    if name == "l_quantity":
        return _draw(seed_of, "l_quantity", 1, 50, n, device).double()
    if name == "l_extendedprice":
        qty = _draw(seed_of, "l_quantity", 1, 50, n, device)
        key = _draw(seed_of, "l_partkey", 1,
                    int(config["scale_factor"]) * 200_000, n, device)
        cents = 90000 + (key // 10) % 20001 + 100 * (key % 1000)
        del key
        cents *= qty
        del qty
        return cents.double() / 100
    if name == "l_discount":
        return _draw(seed_of, "l_discount", 0, 10, n, device).double() / 100
    if name == "l_tax":
        return _draw(seed_of, "l_tax", 0, 8, n, device).double() / 100
    raise KeyError(f"LINEITEM has no generated column {name!r}")
