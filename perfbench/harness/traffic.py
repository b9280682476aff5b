"""The one traffic generator: a mix's data file -> a stream of requests.

A mix (``traffic/<name>.json``) is a closed loop of one client: the
client issues its next request when the last one answers.  Its
``templates`` each name an ``op``, the ``columns`` it runs on (one
template a column, round-robin) and an integer ``share``; ``params`` maps
each parameter to a literal or to a draw from the seed:

* ``{"choice": [a, b, ...]}``: one of the listed values;
* ``{"uniform": [lo, hi], "round": d, "distinct": k}``: a float in
  [lo, hi), rounded to d decimals; ``distinct`` draws k such values once
  and picks among them; ``"count": c`` makes it c such floats, sorted;
* ``{"range": {"lo": [a, b], "width": [c, d]}, "round": d, "distinct":
  k}``: a pair [lo, lo + width], both uniform, rounded, pooled as above.

Requests come in cycles: each cycle holds every template ``share`` times,
in an order drawn from the seed, so every seed runs the same work in
another order.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools

import numpy as np


def subseed(seed: int, *names) -> int:
    """A 63-bit seed derived from ``seed`` and ``names``."""
    digest = hashlib.sha256(repr((int(seed),) + names).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass(frozen=True)
class Template:
    name: str           # "<template>@<column>"
    op: str
    column: str
    share: int
    params: dict        # the mix's specs


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    template: str
    op: str
    column: str
    params: dict        # drawn values


def templates(mix: dict) -> list:
    out = []
    for t in mix["templates"]:
        share = int(t.get("share", 1))
        if share < 1:
            raise ValueError(f"template {t['name']!r}: share must be >= 1")
        for column in t["columns"]:
            out.append(Template(f"{t['name']}@{column}", t["op"], column,
                                share, dict(t.get("params", {}))))
    if not out:
        raise ValueError("a mix needs at least one template")
    return out


class _Param:
    """A parameter spec and, for ``distinct``, its pool of draws."""

    def __init__(self, spec, rng: np.random.Generator):
        self.spec = spec
        self.pool = None
        if isinstance(spec, dict) and "distinct" in spec:
            self.pool = [self._draw(rng) for _ in range(int(spec["distinct"]))]

    def draw(self, rng: np.random.Generator):
        if self.pool is not None:
            return self.pool[int(rng.integers(len(self.pool)))]
        return self._draw(rng)

    def _draw(self, rng):
        spec = self.spec
        if not isinstance(spec, dict):
            return spec
        if "choice" in spec:
            return spec["choice"][int(rng.integers(len(spec["choice"])))]
        digits = spec.get("round")

        def rounded(x):
            return float(np.round(x, digits)) if digits is not None \
                else float(x)

        if "uniform" in spec:
            lo, hi = spec["uniform"]
            if "count" in spec:
                return sorted(rounded(x) for x in
                              rng.uniform(lo, hi, int(spec["count"])))
            return rounded(rng.uniform(lo, hi))
        if "range" in spec:
            lo = rounded(rng.uniform(*spec["range"]["lo"]))
            return [lo, rounded(lo + rng.uniform(*spec["range"]["width"]))]
        raise ValueError(f"unknown parameter spec {spec!r}")


def requests(mix: dict, seed: int):
    """The endless request stream of ``mix`` under ``seed``."""
    temps = templates(mix)
    rng = np.random.default_rng(subseed(seed, "traffic"))
    params = {t.name: {k: _Param(v, rng) for k, v in t.params.items()}
              for t in temps}
    cycle = [t for t in temps for _ in range(t.share)]
    index = itertools.count()
    while True:
        for j in rng.permutation(len(cycle)):
            t = cycle[j]
            yield Request(next(index), t.name, t.op, t.column,
                          {k: p.draw(rng) for k, p in params[t.name].items()})


def cycle_length(mix: dict) -> int:
    return sum(t.share for t in templates(mix))
