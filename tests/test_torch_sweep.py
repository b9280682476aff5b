"""The differential sweep: edge columns x query cases, the port against
the JAX package.

Thirteen edge columns, made from a seed with numpy, in both dtypes and all
four routes (f64 and f32, ALP and ALP_RD): empty, one value, all NaN, all
-0.0, NaN payloads of both signs, values near 3e38 in f32, and NaN, +-Inf
and -0.0 in each route.  The JAX package compresses them; the port reads
the same ALPT bytes and answers on the CPU (``device="cpu"``: the kernels'
plain versions), the JAX engine in interpret mode.  About forty query
cases a column, their argument edges included (DISTINCT also in chunks of
``DISTINCT_CHUNKS`` values, joined across them): +-Inf and NaN bounds,
reversed ranges, k = 0 and k > n, unsorted, NaN and one-edge histograms, q
outside [0, 1] and NaN, bad methods and aggregates, window 0, hop >
window, ``num_groups`` 0 and keys out of range.  Every answer of the port
must equal the JAX package's by bits (dtype, shape; NaN by ``isnan``), or
raise the same exception type.  The columns are spread over this file and
``test_torch_sweep_f64.py``, ``_f32.py`` and ``_small.py`` (``FILES``).
"""

import math
import pathlib

import numpy as np
import pytest

from alp_tpu import container as jcontainer
from alp_tpu import engine as jengine

import alp_tpu_torch
from alp_tpu_torch import engine

N = 2500                         # two vectors and a tail
# DISTINCT_CHUNK values the port's DISTINCT also sorts at a time: three
# chunks, and 26 with a short last one
DISTINCT_CHUNKS = (1000, 97)


def _specials(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    x[[3, 700, 1400]] = [np.nan, np.inf, -np.inf]
    x[[5, 1500]] = -0.0
    x[2100] = -np.nan
    return x


def _column(name: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "empty_f64":
        return np.zeros(0)
    if name == "empty_f32":
        return np.zeros(0, np.float32)
    if name == "one_f64":
        return np.array([-2.5])
    if name == "one_f32":
        return np.array([7.25], np.float32)
    if name == "all_nan_f64":
        return np.full(N, np.nan)
    if name == "all_nan_f32":
        return np.full(N, np.nan, np.float32)
    if name == "all_negzero_f64":
        return np.full(N, -0.0)
    if name == "nan_payloads_f64":
        x = np.round(rng.uniform(-10, 10, N), 1)
        bits = x.view(np.uint64)
        bits[::97] = 0x7FF0000000000001 + rng.integers(0, 1 << 40, 26,
                                                        dtype=np.uint64)
        bits[50::97] = 0xFFF8000000000000 | rng.integers(1, 1 << 40, 26,
                                                         dtype=np.uint64)
        return x
    if name == "near_3e38_f32":
        return (3e38 * (1 - rng.integers(0, 1000, N) / 1e4)).astype(
            np.float32)
    if name == "specials_f64_alp":
        return _specials(np.round(rng.uniform(-100, 100, N), 2))
    if name == "specials_f64_rd":
        return _specials(rng.standard_normal(N))
    if name == "specials_f32_alp":
        return _specials(np.round(rng.uniform(-100, 100, N), 1)).astype(
            np.float32)
    if name == "specials_f32_rd":
        return _specials(rng.standard_normal(N) * 1e6).astype(np.float32)
    raise KeyError(name)


NAMES = ["empty_f64", "empty_f32", "one_f64", "one_f32", "all_nan_f64",
         "all_nan_f32", "all_negzero_f64", "nan_payloads_f64",
         "near_3e38_f32", "specials_f64_alp", "specials_f64_rd",
         "specials_f32_alp", "specials_f32_rd"]
# the columns of each file of the sweep: the JAX engine compiles most of
# the cases again for every column (about 30 s an f64 column in interpret
# mode), so the sweep is cut into files that the test run spreads over its
# workers
FILES = {"test_torch_sweep": ["specials_f64_alp", "specials_f64_rd"],
         "test_torch_sweep_f64": ["all_nan_f64", "nan_payloads_f64"],
         "test_torch_sweep_f32": ["all_nan_f32", "near_3e38_f32",
                                  "specials_f32_alp", "specials_f32_rd"],
         "test_torch_sweep_small": ["empty_f64", "empty_f32", "one_f64",
                                    "one_f32", "all_negzero_f64"]}
# the route each column must take: rowgroup schemes (2 ALP, 1 ALP_RD)
ROUTES = {"specials_f64_alp": {2}, "specials_f64_rd": {1},
          "specials_f32_alp": {2}, "specials_f32_rd": {1}}


def _distinct_in_chunks(col, chunk: int) -> int:
    """The port's DISTINCT on the CPU, sorting ``chunk`` values at a time."""
    saved = engine.DISTINCT_CHUNK
    engine.DISTINCT_CHUNK = chunk
    try:
        return engine.query_distinct(col, device="cpu")
    finally:
        engine.DISTINCT_CHUNK = saved


def _cases(x: np.ndarray) -> list:
    """[(label, call(package module, column, extra keyword arguments))]."""
    n = len(x)
    fin = np.sort(x[np.isfinite(x)]).astype(np.float64)
    a, b = ((float(fin[len(fin) // 4]), float(fin[3 * len(fin) // 4]))
            if fin.size else (-1.0, 1.0))
    lo_e, hi_e = (float(fin[0]) - 1, float(fin[-1]) + 1) if fin.size else (
        -1.0, 1.0)
    inf, nan = math.inf, math.nan
    keys = np.random.default_rng(5).integers(0, 3, n)
    cases = [("sum", lambda q, c, kw: q.query_sum(c, **kw)),
             ("mean", lambda q, c, kw: q.query_mean(c, **kw)),
             ("min", lambda q, c, kw: q.query_min(c, **kw)),
             ("max", lambda q, c, kw: q.query_max(c, **kw)),
             ("distinct", lambda q, c, kw: q.query_distinct(c, **kw))]
    for chunk in DISTINCT_CHUNKS:   # the JAX package sorts in one piece
        cases.append((f"distinct[chunks of {chunk}]",
                      lambda q, c, kw, ch=chunk: _distinct_in_chunks(c, ch)
                      if q is engine else q.query_distinct(c, **kw)))
    for lo, hi in ((a, b), (-inf, inf), (nan, b), (a, nan), (b, a),
                   (-0.0, 0.0), (inf, inf)):
        cases.append((f"filter_count[{lo}, {hi}]",
                      lambda q, c, kw, lo=lo, hi=hi: q.query_filter_count(
                          c, lo, hi, **kw)))
        cases.append((f"filter_sum[{lo}, {hi}]",
                      lambda q, c, kw, lo=lo, hi=hi: q.query_filter_sum(
                          c, lo, hi, **kw)))
    for k, largest in ((0, True), (5, True), (5, False), (n + 3, False),
                       (-1, True)):
        cases.append((f"topk[{k}, {largest}]",
                      lambda q, c, kw, k=k, lg=largest: q.query_topk(
                          c, k, lg, **kw)))
    for edges in (np.linspace(lo_e, hi_e, 16), [hi_e, lo_e],
                  [lo_e, nan, hi_e], [lo_e], [-inf, 0.0, inf]):
        cases.append((f"histogram[{list(edges)[:3]}..]",
                      lambda q, c, kw, e=edges: q.query_histogram(c, e,
                                                                  **kw)))
    for qs, method in (([0.0, 0.3, 0.5, 1.0], "lower"), (1.5, "linear"),
                       (-0.1, "linear"), (nan, "linear"), (0.5, "cubic")):
        cases.append((f"quantile[{qs}, {method}]",
                      lambda q, c, kw, qs=qs, m=method: q.query_quantile(
                          c, qs, m, **kw)))
    # an aggregate neither package knows is left out of the answer
    for G, ks, aggs in ((3, keys, ("sum", "count", "bogus", "min", "max",
                                   "mean")),
                        (0, keys[:0], ("sum",)), (1 << 25, keys, ("sum",)),
                        (2, keys, ("count",))):
        cases.append((f"groupby[G={G}, {aggs}]",
                      lambda q, c, kw, G=G, ks=ks, aggs=aggs:
                      q.query_groupby(c, ks, G, aggs=aggs, **kw)))
    for window, hop in ((1000, 250), (0, None), (100, 300), (10 ** 6, None)):
        cases.append((f"window[{window}, {hop}]",
                      lambda q, c, kw, w=window, h=hop: q.query_window(
                          c, w, hop=h, **kw)))
    return cases


def _outcome(fn):
    try:
        return fn()
    except Exception as e:          # the type is the answer
        return type(e)


def _same(got, want) -> bool:
    if isinstance(want, type) or isinstance(got, type):
        return got is want
    if isinstance(want, dict):
        return (isinstance(got, dict) and list(got) == list(want)
                and all(_same(got[a], want[a]) for a in want))
    g, w = np.asarray(got), np.asarray(want)
    if g.dtype != w.dtype or g.shape != w.shape:
        return False
    if g.dtype.kind == "f":
        nan = np.isnan(w)
        return (np.array_equal(np.isnan(g), nan) and np.array_equal(
            g[~nan].view(f"u{g.itemsize}"), w[~nan].view(f"u{w.itemsize}")))
    return np.array_equal(g, w)


def check_column(name: str) -> None:
    """Every case of ``_cases`` on the column ``name``: the port's answer,
    or its exception type, equals the JAX package's."""
    x = _column(name)
    jcol = jcontainer.compress(x)
    col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
    if name in ROUTES:
        assert set(col.rg_scheme.tolist()) == ROUTES[name]
    bad = []
    for label, call in _cases(x):
        mine = _outcome(lambda: call(engine, col, {"device": "cpu"}))
        theirs = _outcome(lambda: call(jengine, jcol, {}))
        if not _same(mine, theirs):
            bad.append((label, mine, theirs))
    assert not bad, bad


def test_sweep_files_cover_every_column():
    files = sorted(p.stem for p in pathlib.Path(__file__).parent.glob(
        "test_torch_sweep*.py"))
    assert files == sorted(FILES)
    assert sorted(sum(FILES.values(), [])) == sorted(NAMES)


@pytest.mark.parametrize("name", FILES["test_torch_sweep"])
def test_sweep_port_equals_jax(name):
    check_column(name)
