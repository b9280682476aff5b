"""Generated columns, one per decode route, and column tiling.

The reference datasets are not shipped with the repository, so the port's
tests and ``chip_smoke.py`` generate their columns from a seed.  Each
column drives one route through compress and decode: the five profiles of
``bench.py:29-36`` by bit width, ALP vectors of bit width 53-64, ALP_RD in
both precisions, f32 ALP, a column mixing ALP and ALP_RD rowgroups, and
one with NaN, +-Inf and -0.0 exceptions and a tail.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .container import CompressedColumn

VECTOR = C.VECTOR_SIZE
RG_VECTORS = C.N_VECTORS_PER_ROWGROUP
BENCH_PROFILES = ("bench_bw11_city_temperature", "bench_bw20_food_prices",
                  "bench_bw30_bitcoin", "bench_bw42_nyc29", "bench_bw0_gov26")


def route_columns(rng: np.random.Generator, n_vectors: int) -> dict:
    """name -> 1-D array of ``n_vectors`` full vectors (the specials column
    adds a 333-value tail).  ``n_vectors`` should span >= 2 rowgroups so
    the mixed column holds both schemes."""
    n = n_vectors * VECTOR
    cols = {
        "bench_bw11_city_temperature": np.round(rng.uniform(-20, 184.7, n), 1),
        "bench_bw20_food_prices": np.round(rng.uniform(0, 10485.75, n), 2),
        "bench_bw30_bitcoin": np.round(rng.uniform(0, 10.7, n), 8),
        "bench_bw42_nyc29": np.round(rng.uniform(-74.4, -70.0, n), 12),
        "bench_bw0_gov26": np.zeros(n),
    }
    # integers over nearly all of int64; the vectors the planner samples
    # (every 12th of a rowgroup) are half narrow, so it keeps ALP and
    # offers the pair (0, 0): the other vectors take bit widths 63-64
    wide = rng.integers(-2**63 + 4096, 2**63 - 4096, n).astype(np.float64)
    narrow = (np.arange(n) // VECTOR % RG_VECTORS) % 24 == 0
    wide[narrow] = 2.0**53 + 2 * rng.integers(0, 500, int(narrow.sum()))
    cols["f64_alp_bw53_64"] = wide
    cols["f64_alp_rd"] = rng.standard_normal(n)
    cols["f32_alp"] = np.round(rng.uniform(0, 1000, n), 1).astype(np.float32)
    cols["f32_alp_rd"] = rng.standard_normal(n).astype(np.float32)
    mixed = np.round(rng.uniform(0, 100, n), 2)
    rg_values = RG_VECTORS * VECTOR
    for start in range(rg_values, n, 2 * rg_values):
        stop = min(n, start + rg_values)
        mixed[start:stop] = rng.standard_normal(stop - start)
    cols["f64_mixed_alp_rd"] = mixed
    spec = np.round(rng.uniform(-50, 50, n + 333), 3)
    idx = rng.choice(len(spec), 4 * max(1, len(spec) // 256), replace=False)
    for part, value in zip(np.array_split(idx, 4),
                           (np.nan, np.inf, -np.inf, -0.0)):
        spec[part] = value
    cols["f64_specials_tail"] = spec
    return cols


def tile_column(col: CompressedColumn, n_vectors: int) -> CompressedColumn:
    """Repeat a column of whole rowgroups and no tail, cut to exactly
    ``n_vectors`` vectors (``bench.py:tile_column``, to an exact size)."""
    if col.n_vectors % RG_VECTORS or col.n_values != col.n_vectors * VECTOR:
        raise ValueError("tile_column needs whole rowgroups and no tail")
    reps = -(-n_vectors // col.n_vectors)
    n_rg = -(-n_vectors // RG_VECTORS)

    def rg(a):
        return np.tile(a, (reps,) + (1,) * (a.ndim - 1))[:n_rg]

    def vec(a):
        return np.tile(a, reps)[:n_vectors]

    return CompressedColumn(
        dtype=col.dtype, n_values=n_vectors * VECTOR, n_vectors=n_vectors,
        rg_scheme=rg(col.rg_scheme), rd_dict=rg(col.rd_dict),
        rd_dict_size=rg(col.rd_dict_size), rd_left_bw=rg(col.rd_left_bw),
        rd_right_bw=rg(col.rd_right_bw), fac=vec(col.fac), exp=vec(col.exp),
        bit_width=vec(col.bit_width), base=vec(col.base),
        exc_count=vec(col.exc_count),
        packed=(col.packed * reps)[:n_vectors],
        left_packed=(col.left_packed * reps)[:n_vectors],
        exc_values=(col.exc_values * reps)[:n_vectors],
        exc_positions=(col.exc_positions * reps)[:n_vectors],
        enc_max=vec(col.enc_max) if col.enc_max is not None else None)
