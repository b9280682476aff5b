"""GROUP-BY: the port against the JAX package, ``math.fsum`` and site 33.

The route columns of ``tests/test_torch_query.py`` (bit width 0, <= 32,
33-52 and 53-64, f64 ALP_RD, f32 ALP, f32 ALP_RD, mixed ALP + ALP_RD, NaN
of both signs, +-Inf and -0.0 as exceptions, a tail, the TOP-K "fill
pathology" column), made from a seed with numpy, are compressed by the JAX
package and read by the port from the same ALPT bytes.
``alp_tpu_torch.engine.query_groupby(..., device="cpu")`` (the kernels'
plain versions) must equal ``alp_tpu.engine.query_groupby`` by bits
(tolerance 0; NaN equals NaN, the dtypes equal) at both of the
reference's routes on an f64 column: its first call with a keys object
(the one-hot MXU pass, or the sorted path at once above 128 groups) and
its second call with the same keys object (the sorted path through site 33
``sum_extremes_planes_f64`` in interpret mode).  Each group's SUM must
equal ``math.fsum`` of its values.  K18's and K19's plain versions are
held against the Python-int mirror ``engine.host_sum_raw`` and numpy keys,
and K18's per-vector rows against site 33's per-vector reduction where the
values lie in its envelope.  ``tests/test_torch_cuda.py`` holds the
kernels against these plain versions on the card.
"""

import math

import numpy as np
import pytest
import torch

from alp_tpu import engine as jengine
from alp_tpu.kernels import falp as jfalp

from alp_tpu_torch import engine
from alp_tpu_torch.kernels import exact_sum as kes
from test_torch_query import NAMES, _columns, _keys

CPU = {"device": "cpu"}


def _same(got: dict, want: dict) -> bool:
    """Equal keys, dtypes, shapes and bits (NaN by its bits, as both
    packages make it)."""
    if list(got) != list(want):
        return False
    for a in want:
        g, w = np.asarray(got[a]), np.asarray(want[a])
        if g.dtype != w.dtype or g.shape != w.shape:
            return False
        if g.dtype.kind == "f":
            nan = np.isnan(w)
            if not (np.array_equal(np.isnan(g), nan) and np.array_equal(
                    g[~nan].view(f"u{g.itemsize}"),
                    w[~nan].view(f"u{w.itemsize}"))):
                return False
        elif not np.array_equal(g, w):
            return False
    return True


def _group_keys(n: int, G: int, seed: int, ordered: bool) -> np.ndarray:
    """Seeded int64 keys in [0, G); with G >= 6 group G // 2 and (ordered)
    the first and the last group are left empty."""
    rng = np.random.default_rng(seed)
    if G < 6:
        keys = rng.integers(0, G, n)
    else:
        empty = {G // 2} | ({0, G - 1} if ordered else set())
        keys = rng.choice([g for g in range(G) if g not in empty], n)
    return np.sort(keys) if ordered else keys.astype(np.int64)


def _fsum_group(sel: np.ndarray) -> float:
    """The reference SUM of a group: math.fsum, the IEEE rules for NaN and
    infinities, an f32 group's double rounded to float32."""
    pinf, ninf = bool(np.isposinf(sel).any()), bool(np.isneginf(sel).any())
    if np.isnan(sel).any() or (pinf and ninf):
        return math.nan
    if pinf or ninf:
        return math.inf if pinf else -math.inf
    total = math.fsum(sel.astype(np.float64).tolist())
    return float(sel.dtype.type(total))


def _check_fsum(res: dict, x: np.ndarray, keys: np.ndarray, G: int):
    counts = np.bincount(keys, minlength=G)
    assert np.array_equal(res["count"], counts)
    for g in range(G):
        want = _fsum_group(x[keys == g])
        got = float(res["sum"][g])
        assert (math.isnan(got) and math.isnan(want)) or got == want, g


@pytest.mark.parametrize("G", [1, 6, 200])
@pytest.mark.parametrize("name", NAMES)
def test_groupby_equals_jax_at_both_routes(name, G):
    """Random keys.  At G = 6 an f64 column is asked twice with the same
    keys object, so the reference answers once by its MXU pass and once by
    its sorted path (site 33); at G = 200 its first call takes the sorted
    path already, and at G = 1 the MXU pass."""
    x, jcol, col = _columns(name)
    keys = _group_keys(len(x), G, G, ordered=False)
    got = engine.query_groupby(col, keys, G, **CPU)
    assert _same(got, jengine.query_groupby(jcol, keys, G)), (name, G)
    if x.dtype == np.float64 and G == 6:
        again = jengine.query_groupby(jcol, keys, G)
        assert isinstance(jcol._gb_sorted.get((id(keys), G)), dict)
        assert _same(got, again), (name, G)
    _check_fsum(got, x, keys, G)


@pytest.mark.parametrize("name", NAMES)
def test_groupby_ordered_keys_equal_jax(name):
    """Keys in order, the first, a middle and the last group left empty:
    the port's K18 route; the reference's MXU pass, then its sorted path
    over the column itself."""
    x, jcol, col = _columns(name)
    G = 9
    keys = _group_keys(len(x), G, 90, ordered=True)
    got = engine.query_groupby(col, keys, G, **CPU)
    assert col.plan("cpu").vector_sums is not None
    assert _same(got, jengine.query_groupby(jcol, keys, G))
    if x.dtype == np.float64:
        assert _same(got, jengine.query_groupby(jcol, keys, G))
    _check_fsum(got, x, keys, G)
    assert np.isnan(got["mean"][0]) and got["sum"][0] == 0.0
    assert np.isnan(got["min"][G - 1]) and np.isnan(got["max"][G - 1])


def test_groupby_aggregate_subsets_and_order_equal_jax():
    x, jcol, col = _columns("specials")
    keys = _group_keys(len(x), 4, 4, ordered=False)
    for aggs in (("max",), ("mean", "count"), ("min", "bogus", "sum")):
        got = engine.query_groupby(col, keys, 4, aggs=aggs, **CPU)
        assert _same(got, jengine.query_groupby(jcol, keys, 4, aggs=aggs))


def test_groupby_validation_and_empty_column_equal_jax():
    from alp_tpu import container as jcontainer
    import alp_tpu_torch
    data = np.arange(100, dtype=np.float64)
    jcol = jcontainer.compress(data)
    col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
    bad = [(np.zeros(5, np.int64), 3), (np.full(100, 3), 3),
           (np.zeros(100, np.int64), 0), (np.full(100, -1), 3),
           (np.zeros(100, np.int64), (1 << 24) + 1)]
    for keys, G in bad:
        with pytest.raises(ValueError) as mine:
            engine.query_groupby(col, keys, G, **CPU)
        with pytest.raises(ValueError) as theirs:
            jengine.query_groupby(jcol, keys, G)
        assert str(mine.value) == str(theirs.value)
    for dtype in (np.float64, np.float32):
        empty = np.zeros(0, dtype)
        jcol = jcontainer.compress(empty)
        col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
        keys = np.zeros(0, np.int64)
        assert _same(engine.query_groupby(col, keys, 3, **CPU),
                     jengine.query_groupby(jcol, keys, 3))


@pytest.mark.parametrize("name", NAMES)
def test_group_kernel_plain_versions_equal_host_mirror(name):
    """K18's rows and keys of every vector, and K19's totals, counts and
    keys of every group at G = 6, against ``engine.host_sum_raw`` and
    numpy keys of the input; K19 over two runs equals one."""
    x, _, col = _columns(name)
    plan = col.plan("cpu")
    n = len(x)
    sums, vkeys = engine.vector_sums(plan)
    kt = engine._key_type(x.dtype)
    vkeys = vkeys.numpy().view(kt)
    keys = _keys(x)
    for v in range(plan.n_vectors):
        part = x[v * 1024:(v + 1) * 1024]
        row = sums[v].tolist()
        assert engine.join_totals(row, x.dtype) == engine.host_sum_raw(part)
        assert (vkeys[v, 0], vkeys[v, 1]) == (
            keys[v * 1024:(v + 1) * 1024].min(),
            keys[v * 1024:(v + 1) * 1024].max())
    G = 6
    gk = _group_keys(n, G, 6, ordered=False)
    kv = np.full(plan.n_vectors * 1024, -1, np.int32)
    kv[:n] = gk
    kv = torch.from_numpy(kv.reshape(-1, 1024))
    outs, ext = engine.group_reduce(plan, kv, G)
    runs, ext2 = engine.group_reduce(plan, kv, G, run_values=3 * 1024 + 1)
    assert len(outs) == 1 and len(runs) == -(-plan.n_vectors // 3)
    assert torch.equal(sum(runs), outs[0]) and torch.equal(ext2, ext)
    out = outs[0]
    W = kes.WINDOWS[plan.bits_dtype]
    ext = ext.numpy().view(kt)
    for g in range(G):
        sel = gk == g
        assert engine.join_totals(out[g, :W + 3].tolist(), x.dtype) == \
            engine.host_sum_raw(x[sel])
        assert int(out[g, W + 3]) == int(sel.sum())
        want = ((keys[sel].min(), keys[sel].max()) if sel.any()
                else (~kt(0), kt(0)))            # an empty group
        assert (ext[g, 0], ext[g, 1]) == want


def _site33_per_vector(x: np.ndarray, n_vectors: int):
    """``alp_tpu.kernels.falp.sum_extremes_planes_f64`` on the planes of the
    first ``n_vectors`` whole vectors of ``x`` (8 a tile: value k of a
    vector at row k // 16, lane 16 * slot + k % 16), reduced per vector as
    ``alp_tpu/engine.py:2573-2601`` does: (the exact sum times 2^1075, the
    NaN, +Inf and -Inf counts, the out-of-envelope count, the least and
    largest unsigned key) a vector."""
    G = -(-n_vectors // 8)
    bits = np.zeros(G * 8 * 1024, np.uint64)
    bits[:n_vectors * 1024] = x[:n_vectors * 1024].view(np.uint64)
    tiles = bits.reshape(G, 8, 64, 16).transpose(0, 2, 1, 3).reshape(
        G, 64, 128)
    se = np.asarray(jfalp.sum_extremes_planes_f64(
        (tiles >> np.uint64(32)).astype(np.uint32),
        (tiles & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    rows = (se[:, :16].astype(np.int64).reshape(G, 16, 8, 16).sum(axis=3)
            .transpose(0, 2, 1).reshape(-1, 16))
    ext = se[:, 16:20].reshape(G, 4, 8, 16).transpose(0, 2, 1, 3).reshape(
        -1, 4, 16).astype(np.int64) & 0xFFFFFFFF
    ext ^= 1 << 31                        # biased i32 words -> key words
    out = []
    for v in range(n_vectors):
        total = sum((int(rows[v, w]) + (int(rows[v, w + 6]) << 16))
                    << (32 * (jfalp._SUM_W0 + w)) for w in range(6))
        least = min(zip(ext[v, 0].tolist(), ext[v, 1].tolist()))
        largest = max(zip(ext[v, 2].tolist(), ext[v, 3].tolist()))
        out.append((total, *rows[v, 12:16].tolist(),
                    (least[0] << 32) | least[1],
                    (largest[0] << 32) | largest[1]))
    return out


@pytest.mark.parametrize("name", [n for n in NAMES if n not in
                                  ("f32_alp", "f32_rd")])
def test_k18_rows_equal_site_33(name):
    """K18's plain rows and keys, per whole vector, against site 33 in
    interpret mode where the vector's values lie in its envelope."""
    x, _, col = _columns(name)
    plan = col.plan("cpu")
    whole = len(x) // 1024
    sums, vkeys = engine.vector_sums(plan)
    vkeys = vkeys.numpy().view(np.uint64)
    W = kes.WINDOWS[plan.bits_dtype]
    checked = 0
    for v, (total, nan, pinf, ninf, rare, least, largest) in enumerate(
            _site33_per_vector(x, whole)):
        if rare:
            continue
        row = sums[v].tolist()
        assert engine.join_totals(row, x.dtype)[0] == total, v
        assert row[W:W + 3] == [nan, pinf, ninf], v
        assert (int(vkeys[v, 0]), int(vkeys[v, 1])) == (least, largest), v
        checked += 1
    assert checked == whole


def _random_total(rng, scale: int) -> int:
    """A signed exact total times 2^scale: random bits of any length, ties
    (an odd multiple of half a unit in the last place), powers of two and
    runs of ones, the smallest rounding to subnormals or to zero, the
    largest past DBL_MAX."""
    kind = rng.integers(0, 5)
    sign = int(rng.choice([-1, 1]))
    if kind == 0:
        return sign * int.from_bytes(rng.bytes(int(rng.integers(1, 280))),
                                     "little")
    if kind == 1:
        m = int(rng.integers(1 << 52, 1 << 53))
        return sign * ((2 * m + 1) << int(rng.integers(0, scale + 970)))
    if kind == 2:
        return sign << int(rng.integers(0, scale + 1030))
    if kind == 3:
        return sign * (((1 << int(rng.integers(54, 400))) - 1)
                       << int(rng.integers(0, scale + 600)))
    return sign * int.from_bytes(rng.bytes(int(rng.integers(1, 40))),
                                 "little")


def _limbs_of_totals(totals: dict, G: int) -> np.ndarray:
    """The carried int64 limbs of ``engine.Groups`` (base 0) from {g:
    Python int}."""
    L = max((abs(t).bit_length() for t in totals.values()), default=0)
    L = L // 32 + 2
    limbs = np.zeros((G, L), np.int64)
    for g, t in totals.items():
        row = np.frombuffer(abs(t).to_bytes(4 * L, "little"), "<u4")
        limbs[g] = -row.astype(np.int64) if t < 0 else row
    return engine._carry(limbs)


@pytest.mark.parametrize("mean", [False, True], ids=["sum", "mean"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_finish_rounds_every_group_as_int_division(dtype, mean):
    """``engine._rounded``, the vectorised rounding of the groups' limbs,
    equals Python's ``int / int`` (one rounding to nearest even) on every
    group: ties, subnormal and zero results, counts up to 2^33; a result
    past DBL_MAX raises ``OverflowError`` as the division does."""
    rng = np.random.default_rng(21 + mean)
    scale = engine._SCALE[np.dtype(dtype)]
    G = 3000
    totals = {g: _random_total(rng, scale) for g in range(G)}
    ct = rng.choice([1, 2, 3, 7, 1000, (1 << 31) + 5, (1 << 32) - 1, 1 << 33],
                    G).astype(np.int64)
    gr = engine.Groups(_limbs_of_totals(totals, G), 0,
                       np.zeros((G, 3), np.int64), ct,
                       np.zeros(G, np.uint64), np.zeros(G, np.uint64))
    assert gr.totals == {g: t for g, t in totals.items() if t}
    assert gr.grand_total() == sum(totals.values())
    want = np.zeros(G)
    fits = np.ones(G, bool)
    for g, t in totals.items():
        try:
            want[g] = t / ((int(ct[g]) if mean else 1) << scale)
        except OverflowError:
            fits[g] = False
    agg = "mean" if mean else "sum"
    got = engine._rounded(gr, scale, fits, (agg,))[agg]
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    if not fits.all():
        with pytest.raises(OverflowError):
            engine._rounded(gr, scale, ~fits, (agg,))
