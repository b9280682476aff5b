"""Predicate and order queries: the port against the JAX package and numpy.

One small column per route (bit width 0, <= 32, 33-52 and 53-64, f64
ALP_RD, f32 ALP, f32 ALP_RD, a mixed ALP + ALP_RD column, NaN of both
signs, a signaling NaN, +-Inf and -0.0 as exceptions in f64 ALP, f64
ALP_RD and f32 ALP, a tail whose last value lies inside some of the
ranges and outside others, and the "fill pathology" column of
``tests/test_engine.py``), made from a seed with numpy.  The JAX package
compresses; the port reads the same ALPT bytes and runs on the CPU
(``device="cpu"``: the kernels' plain versions), the JAX engine in
interpret mode.  Every answer is compared by bits (tolerance 0): floats by
``struct``, arrays by their unsigned views.  Each answer is also held
against numpy on the input's total-order keys: counts, a key sort,
``np.histogram`` and ``math.fsum`` of the selected values.

The plain versions of K15 ``key_counts`` and K16 ``key_extremes`` are held
against a numpy mirror on the decoded bits of every bucket, and the
filtered K5-K8 against ``engine.host_sum_raw`` of the selected values.
``tests/test_torch_cuda.py`` holds the kernels against these plain
versions on the card.
"""

import math
import struct

import numpy as np
import pytest
import torch

from alp_tpu import container as jcontainer
from alp_tpu import engine as jengine

import alp_tpu_torch
from alp_tpu_torch import engine
from alp_tpu_torch.kernels import exact_sum as kes
from alp_tpu_torch.kernels import keys as kkeys

CPU = {"device": "cpu"}


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(f"u{x.dtype.itemsize}")


def _keys(x: np.ndarray) -> np.ndarray:
    """numpy total-order keys (-0.0 as +0.0)."""
    b = _bits(x)
    sbit = b.dtype.type(1) << b.dtype.type(8 * b.itemsize - 1)
    b = np.where(b == sbit, b.dtype.type(0), b)
    return np.where((b & sbit) != 0, ~b, b | sbit)


def _same(a, b) -> bool:
    return struct.pack("<d", float(a)) == struct.pack("<d", float(b))


def _same_array(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(_bits(a), _bits(b)))


def _column(name: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "bw0_zeros":                  # all zero: MIN/MAX give +0.0
        return np.where(np.arange(1024) % 2, 0.0, -0.0)
    if name == "bw_le32":                    # a tail, its last value 0.5
        x = np.round(rng.uniform(-5, 5, 3000), 2)
        x[-1] = 0.5
        return x
    if name == "bw_33_52":
        rng = np.random.default_rng(311)
        return np.round(rng.uniform(0, 1e10, 3000), 2)
    if name == "bw_53_64":                   # alp_tpu_torch.columns' recipe
        n = 13 * 1024
        x = rng.integers(-2**63 + 4096, 2**63 - 4096, n).astype(np.float64)
        narrow = (np.arange(n) // 1024) % 24 == 0
        x[narrow] = 2.0**53 + 2 * rng.integers(0, 500, int(narrow.sum()))
        return x
    if name == "f64_rd":
        x = rng.standard_normal(3000)
        x[[3, 900, 1800, 2100]] = [np.nan, np.inf, -np.inf, -np.nan]
        x[[5, 1500]] = -0.0
        return x
    if name == "f32_alp":
        x = np.round(rng.uniform(-50, 50, 2500), 2).astype(np.float32)
        x[[7, 70, 700]] = [np.inf, -np.inf, -0.0]
        x.view(np.uint32)[1000] = 0x7F800001    # signaling NaN
        x.view(np.uint32)[1001] = 0xFFC00000    # -NaN
        return x
    if name == "f32_rd":
        return (rng.standard_normal(3000) * 1e8).astype(np.float32)
    if name == "mixed_alp_rd":
        x = np.round(rng.uniform(0, 100, 100 * 1024 + 1500), 2)
        x[100 * 1024:] = rng.standard_normal(1500)
        return x
    if name == "specials":
        x = np.round(rng.uniform(-100, 100, 3000), 1)
        x[[3, 900, 1800]] = [np.nan, np.inf, -np.inf]
        x[[5, 1500]] = -0.0
        x[2100] = -np.nan                        # sign bit set
        x.view(np.uint64)[2200] = 0x7FF0000000000123   # signaling, payload
        return x
    if name == "fill_pathology":
        # tests/test_engine.py::test_topk_fill_pathology_falls_back
        rng = np.random.default_rng(80)
        rest = np.round(rng.uniform(0, 10, 1024 * 9), 2)
        v0 = np.round(rng.uniform(0, 10, 1024), 2)
        v0[0] = 100.0
        v0[5::5] = -np.nan
        return np.concatenate([v0, rest])
    raise KeyError(name)


NAMES = ["bw0_zeros", "bw_le32", "bw_33_52", "bw_53_64", "f64_rd",
         "f32_alp", "f32_rd", "mixed_alp_rd", "specials", "fill_pathology"]
_CACHE = {}


def _columns(name: str):
    """(input, JAX column, port column), compressed once."""
    if name not in _CACHE:
        x = _column(name)
        jcol = jcontainer.compress(x)
        _CACHE[name] = (x, jcol, alp_tpu_torch.CompressedColumn.from_bytes(
            jcol.to_bytes()))
    return _CACHE[name]


def _ranges(x: np.ndarray) -> list:
    """Two ranges between the column's own values (bw_le32's tail value
    0.5 lies in the first and not in the second), every value, and a range
    that starts at -0.0."""
    fin = np.sort(x[np.isfinite(x)])
    q = [float(fin[i * len(fin) // 5]) for i in (1, 3, 4)]
    return [(q[0], q[1]), (q[1], q[2]), (-math.inf, math.inf), (-0.0, q[1])]


def _count_ref(x, lo, hi) -> int:
    k = _keys(x)
    klo = engine._float_key(lo, x.dtype)
    khi = engine._float_key(hi, x.dtype)
    return int(((k >= k.dtype.type(klo)) & (k <= k.dtype.type(khi))).sum())


def _fsum_ref(x, lo, hi):
    """math.fsum of the values whose key lies in [lo, hi], as the column
    dtype's scalar (IEEE answers for NaN and infinities)."""
    k = _keys(x)
    klo = engine._float_key(lo, x.dtype)
    khi = engine._float_key(hi, x.dtype)
    sel = x[(k >= k.dtype.type(klo)) & (k <= k.dtype.type(khi))].astype(
        np.float64)
    if np.isnan(sel).any() or (np.isposinf(sel).any()
                               and np.isneginf(sel).any()):
        total = math.nan
    elif np.isinf(sel).any():
        total = float(sel[np.isinf(sel)][0])
    else:
        total = math.fsum(sel.tolist())
    return x.dtype.type(total)


def _topk_ref(x, k: int, largest: bool) -> np.ndarray:
    """The k largest (smallest) values in the total order, +-0 as +0.0 and
    an f32 value through a Python float (a signaling NaN comes out
    quiet), as the JAX package returns them."""
    order = np.argsort(_keys(x), kind="stable")
    pick = x[order[::-1][:k] if largest else order[:k]]
    pick = np.where(pick == 0, x.dtype.type(0), pick)
    if x.dtype == np.float32:
        pick = pick.astype(np.float64).astype(np.float32)
    return pick.astype(x.dtype)


def _hist_ref(x, edges) -> np.ndarray:
    """Bins [e_i, e_i+1) in key space, the last one closed."""
    k = np.sort(_keys(x))
    ek = np.array([engine._float_key(e, x.dtype) for e in edges], k.dtype)
    left = np.searchsorted(k, ek, side="left")
    out = np.diff(left)
    out[-1] += np.searchsorted(k, ek[-1], side="right") - left[-1]
    return out


def _edges(x, n: int) -> np.ndarray:
    fin = x[np.isfinite(x)]
    return np.linspace(float(fin.min()) - 1, float(fin.max()) + 1, n)


# ---------------------------------------------------------------------------
# every query against alp_tpu.engine and numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_queries_equal_jax_and_numpy(name):
    """Every query on every column against the JAX engine and numpy; TOP-K
    here over the whole column (the full decode path), and at small k in
    ``test_topk_small_k_equals_jax``."""
    x, jcol, col = _columns(name)
    for lo, hi in _ranges(x):
        got = alp_tpu_torch.query_filter_count(col, lo, hi, **CPU)
        assert got == jengine.query_filter_count(jcol, lo, hi), (lo, hi)
        assert got == _count_ref(x, lo, hi), (lo, hi)
    for port, jax, pick in ((alp_tpu_torch.query_min, jengine.query_min,
                             np.min),
                            (alp_tpu_torch.query_max, jengine.query_max,
                             np.max)):
        got = port(col, **CPU)
        assert _same(got, jax(jcol))
        assert _same(got, engine._key_float(int(pick(_keys(x))), x.dtype))
    k = col.n_values + 7
    for largest in (True, False):
        got = alp_tpu_torch.query_topk(col, k, largest, **CPU)
        assert _same_array(got, jengine.query_topk(jcol, k, largest))
        assert _same_array(got, _topk_ref(x, len(x), largest))
    edges = _edges(x, 7)
    got = alp_tpu_torch.query_histogram(col, edges, **CPU)
    assert np.array_equal(got, jengine.query_histogram(jcol, edges))
    assert np.array_equal(got, _hist_ref(x, edges))
    if not np.isnan(x).any():
        assert np.array_equal(got, np.histogram(
            x, edges.astype(x.dtype))[0])
    for lo, hi in _ranges(x)[:3]:
        got = alp_tpu_torch.query_filter_sum(col, lo, hi, **CPU)
        want = jengine.query_filter_sum(jcol, lo, hi)
        assert type(got) is type(want) and _same(got, want)
        assert _same(got, _fsum_ref(x, lo, hi))


@pytest.mark.parametrize("name", NAMES)
def test_metadata_scan_and_compression_equal_jax(name):
    x, jcol, col = _columns(name)
    assert alp_tpu_torch.query_count_exceptions(col) == \
        jengine.query_count_exceptions(jcol)
    plan, values = alp_tpu_torch.query_scan(col, **CPU)
    assert plan is col.plan("cpu")
    got = values.reshape(-1)[:col.n_values].numpy()
    assert _same_array(got, jcontainer.decompress(jcol))
    assert _same_array(got, x)


def test_compression_stats_equal_jax():
    x = _column("mixed_alp_rd")
    cc, stats = alp_tpu_torch.query_compression(x)
    jcc, jstats = jengine.query_compression(x)
    assert cc.to_bytes() == jcc.to_bytes()
    assert set(stats) == set(jstats)
    assert stats["bits_per_value"] == jstats["bits_per_value"]
    assert stats["seconds"] > 0 and stats["throughput_gbps"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_topk_every_k_equals_numpy(name):
    """k in {0, 1, 5, 128, > n_vectors, > n_values}, both orders: the
    K16 path (k <= n_vectors) and the full decode (k > n_vectors)."""
    x, _, col = _columns(name)
    for k in (0, 1, 5, 128, col.n_vectors + 1, col.n_values + 7):
        for largest in (True, False):
            got = alp_tpu_torch.query_topk(col, k, largest, **CPU)
            want = _topk_ref(x, min(k, len(x)), largest)
            assert _same_array(got, want), (k, largest)


@pytest.mark.parametrize("name,k,largest", [
    ("specials", 5, True), ("f64_rd", 3, False), ("f32_alp", 2, True),
    ("fill_pathology", 3, True)])
def test_topk_small_k_equals_jax(name, k, largest):
    """k <= n_vectors, the K16 path; fill_pathology is the column on which
    the JAX package's fused TOP-K falls back to its plane path."""
    _, jcol, col = _columns(name)
    assert _same_array(alp_tpu_torch.query_topk(col, k, largest, **CPU),
                       jengine.query_topk(jcol, k, largest))


def test_topk_every_k_equals_jax():
    """Every k of ``test_topk_every_k_equals_numpy``, both orders, against
    the JAX engine on the column of both NaN signs, a signaling NaN, +-Inf
    and -0.0."""
    _, jcol, col = _columns("specials")
    for k in (0, 1, 5, 128, col.n_vectors + 1, col.n_values + 7):
        for largest in (True, False):
            assert _same_array(alp_tpu_torch.query_topk(col, k, largest,
                                                        **CPU),
                               jengine.query_topk(jcol, k, largest)), k


@pytest.mark.parametrize("name", ["specials", "f32_rd"])
def test_histogram_past_one_chunk_equals_jax_scan(name):
    """More edges than K15 takes in one launch: the same one path."""
    x, jcol, col = _columns(name)
    edges = _edges(x, kkeys.MAX_THRESHOLDS + 300)
    got = alp_tpu_torch.query_histogram(col, edges, **CPU)
    assert np.array_equal(got, jengine._query_histogram_scan(jcol, edges))
    assert np.array_equal(got, _hist_ref(x, edges))


def test_histogram_refuses_bad_edges_as_jax():
    _, jcol, col = _columns("bw_le32")
    for edges in ([1.0], [2.0, 1.0], [0.0, 0.0, 1.0]):
        with pytest.raises(ValueError, match="strictly increasing"):
            alp_tpu_torch.query_histogram(col, edges, **CPU)
        with pytest.raises(ValueError, match="strictly increasing"):
            jengine.query_histogram(jcol, edges)


def test_topk_refuses_negative_k_as_jax():
    """k < 0 raises ValueError before any plan is built, the exception
    type of the reference (``jax.lax.top_k``)."""
    x = np.round(np.random.default_rng(11).uniform(0, 9, 2000), 1)
    jcol = jcontainer.compress(x)
    col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
    with pytest.raises(ValueError) as mine:
        alp_tpu_torch.query_topk(col, -1, **CPU)
    with pytest.raises(Exception) as theirs:
        jengine.query_topk(jcol, -1)
    assert type(mine.value) is type(theirs.value) is ValueError
    assert not col._plans


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_min_max_of_an_empty_column_equal_jax(dtype):
    """The reference's fill keys: MIN all ones, MAX key 0, through a
    Python float for f32; no plan is built."""
    jcol = jcontainer.compress(np.zeros(0, dtype))
    col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
    lo = alp_tpu_torch.query_min(col, **CPU)
    hi = alp_tpu_torch.query_max(col, **CPU)
    assert _same(lo, jengine.query_min(jcol))
    assert _same(hi, jengine.query_max(jcol))
    want = ((0x7FFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF) if dtype == np.float64
            else (0x7FFFFFFFE0000000, 0xFFFFFFFFE0000000))
    assert (struct.unpack("<Q", struct.pack("<d", lo))[0],
            struct.unpack("<Q", struct.pack("<d", hi))[0]) == want
    assert not col._plans


def test_empty_selection_and_reversed_bounds():
    x, jcol, col = _columns("bw_le32")
    for lo, hi in ((3.0, -3.0), (100.0, 200.0)):
        assert alp_tpu_torch.query_filter_count(col, lo, hi, **CPU) == \
            jengine.query_filter_count(jcol, lo, hi) == 0
        got = alp_tpu_torch.query_filter_sum(col, lo, hi, **CPU)
        want = jengine.query_filter_sum(jcol, lo, hi)
        assert type(got) is type(want) and _same(got, want)
    for dt in (np.float64, np.float32):
        empty = alp_tpu_torch.query_topk(
            alp_tpu_torch.compress(np.array([1.5, 2.5], dt)), 0, **CPU)
        assert empty.shape == (0,) and empty.dtype == dt


def test_key_helpers_equal_jax():
    values = [0.0, -0.0, 1.5, -1.5, math.inf, -math.inf, math.nan, 1e-310,
              -5e-324, 3.4e38, 1e300, 0.1]
    for dt in (np.float64, np.float32):
        assert engine._float_keys(values, dt).tolist() == [
            jengine._float_key(v, dt) for v in values]
        for v in values:
            key = engine._float_key(v, dt)
            assert key == jengine._float_key(v, dt)
            assert _same(engine._key_float(key, dt),
                         jengine._key_float(key, dt))
        bits = _bits(np.array(values, dt))
        for klo, khi in ((0, 2 ** (8 * bits.itemsize) - 1),
                         (engine._float_key(-1.0, dt),
                          engine._float_key(2.0, dt))):
            assert np.array_equal(engine._pred_key(bits, klo, khi),
                                  jengine._pred_key(bits, klo, khi))


def test_queries_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    col = alp_tpu_torch.compress(np.linspace(0, 1, 3000))
    for query in (lambda **d: alp_tpu_torch.query_filter_count(col, 0, 1,
                                                                **d),
                  lambda **d: alp_tpu_torch.query_min(col, **d),
                  lambda **d: alp_tpu_torch.query_max(col, **d),
                  lambda **d: alp_tpu_torch.query_topk(col, 3, **d),
                  lambda **d: alp_tpu_torch.query_histogram(col, [0, 1],
                                                             **d),
                  lambda **d: alp_tpu_torch.query_filter_sum(col, 0, 1, **d),
                  lambda **d: alp_tpu_torch.query_scan(col, **d)):
        for kwargs in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                query(**kwargs)


# ---------------------------------------------------------------------------
# the plain versions of K15, K16 and the filtered K5-K8
# ---------------------------------------------------------------------------

def _bucket_bits(x: np.ndarray, rows: torch.Tensor, n_values: int):
    """numpy: the bits of vectors ``rows`` and the mask of their real
    values (the pad of a partial last vector out)."""
    pad = -len(x) % 1024
    full = np.concatenate([_bits(x), np.zeros(pad, _bits(x).dtype)])
    r = rows.numpy()
    pos = r[:, None] * 1024 + np.arange(1024)
    return full.reshape(-1, 1024)[r], pos < n_values


@pytest.mark.parametrize("name", NAMES)
def test_key_kernel_plain_versions_equal_numpy(name):
    x, _, col = _columns(name)
    plan = col.plan("cpu")
    ut = np.uint64 if plan.f64 else np.uint32
    rng = np.random.default_rng(7)
    thr = np.unique(np.concatenate([
        np.sort(_keys(x))[::97],
        rng.integers(0, np.iinfo(ut).max, 40, dtype=ut, endpoint=True)]))
    thr_t = torch.from_numpy(thr.view(f"i{thr.itemsize}").copy())
    for call in engine.key_calls(plan):
        bits, valid = _bucket_bits(x, call.rows, col.n_values)
        keys = _keys(bits.view(x.dtype))
        want = np.bincount(np.searchsorted(thr, keys[valid], side="left"),
                           minlength=len(thr) + 1)
        assert np.array_equal(call.counts_plain(thr_t).numpy(), want)
        lo = np.where(valid, keys, np.iinfo(ut).max).min(axis=1)
        hi = np.where(valid, keys, 0).max(axis=1)
        got = call.extremes_plain().numpy().view(ut)
        assert np.array_equal(got, np.stack([lo, hi], axis=1))


@pytest.mark.parametrize("name", NAMES)
def test_filtered_sum_plain_versions_equal_host_mirror(name):
    x, _, col = _columns(name)
    plan = col.plan("cpu")
    width = 64 if plan.f64 else 32
    for lo, hi in _ranges(x):
        klo = engine._float_key(lo, x.dtype)
        khi = engine._float_key(hi, x.dtype)
        got = engine.join_totals(engine.exact_sum_totals(
            plan, key_range=(klo, khi)).tolist(), x.dtype)
        sel = engine._pred_key(_bits(x), klo, khi)
        assert got == engine.host_sum_raw(x[sel]), (lo, hi)
    # over every key the filtered kernels give today's totals exactly
    for call in engine.sum_calls(plan, (0, (1 << width) - 1)):
        unfiltered = kes.KERNELS[call.kernel][1](*call.args)
        assert torch.equal(call.plain(), unfiltered)


@pytest.mark.parametrize("name", ["f64_rd", "mixed_alp_rd", "bw_le32",
                                  "f32_alp"])
def test_decode_vectors_equals_the_full_decode(name):
    _, _, col = _columns(name)
    plan = col.plan("cpu")
    ids = torch.tensor(sorted({0, plan.n_vectors - 1, plan.n_vectors // 2}))
    full = plan.run().view(plan.bits_dtype)
    assert torch.equal(plan.decode_vectors(ids).view(plan.bits_dtype),
                       full[ids])
