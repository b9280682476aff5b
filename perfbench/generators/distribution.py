"""Columns drawn from a stated distribution, on the device from the seed.

A column's spec in its configuration is one of

* ``{"uniform": [lo, hi], "decimals": d}``: uniform in [lo, hi), rounded
  to d decimals (``rint(x * 10^d) / 10^d``, numpy's ``np.round``);
* ``{"normal": [mean, std]}``: normal;
* ``{"constant": c}``: every value c.

The five profiles and the ALP_RD column of the ALP paper's double
datasets are copied from ``alp_tpu_torch/columns.py`` (``route_columns``:
the ``bench.py`` profiles by bit width and ``f64_alp_rd``).
"""

from __future__ import annotations

import torch


def column(name: str, config: dict, n: int, seed_of, device) -> torch.Tensor:
    spec = config["columns"][name]
    if "constant" in spec:
        return torch.full((n,), float(spec["constant"]), dtype=torch.float64,
                          device=device)
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(name))
    if "normal" in spec:
        mean, std = spec["normal"]
        x = torch.randn(n, generator=g, dtype=torch.float64, device=device)
        return x.mul_(std).add_(mean)
    lo, hi = spec["uniform"]
    x = torch.rand(n, generator=g, dtype=torch.float64, device=device)
    x.mul_(hi - lo).add_(lo)
    if "decimals" in spec:
        scale = 10.0 ** int(spec["decimals"])
        x.mul_(scale).round_().div_(scale)
    return x
