"""QUANTILE / MEDIAN: the port against the JAX package and numpy.

The route columns of ``tests/test_torch_query.py`` (bit width 0 with both
zero signs, <= 32 with a tail, 33-52 and 53-64, f64 ALP_RD, f32 ALP, f32
ALP_RD, the mixed column, NaN of both signs, a signaling NaN, +-Inf and
-0.0 as exceptions, the "fill pathology" column) and the cases of
``tests/test_quantile.py`` (duplicates, a constant column, n in {1, 2, 3,
100, 1025}, infinities without NaN, NaN propagation, the empty column),
made from a seed with numpy.  The port reads the JAX package's ALPT bytes
and runs on the CPU (``device="cpu"``: K17's plain version); the JAX
engine runs in interpret mode.  Its first call on a column compiles one
``while_loop`` program for each number of ranks in a dispatch (5-14 s), so
each JAX column is compressed once and asked one tuple of quantiles; the
columns past the first six are held against numpy alone.

Answers are compared by bits (tolerance 0): with the JAX package always,
with ``np.quantile`` where it is a number.  Where the column holds a NaN
every answer is NaN (numpy returns the column's own NaN, the port and JAX
a quiet NaN), compared by ``isnan``.  On the ``bw0_zeros`` column (-0.0
and +0.0 alternate) the port and JAX return +0.0, the float of the zeros'
shared key, while numpy 2.0 returns whichever zero its partition meets:
-0.0 for ``lower`` at q = 0, 0.1, 0.5 and 0.9, for ``higher`` at 0, 0.1
and 0.75, for ``nearest`` at 0 and 0.1, +0.0 for ``linear`` and
``midpoint``; that column compares with numpy by ``==``.

K17's plain version is held against the JAX rank passes
(``engine._bucket_rankpass``, every group of the JAX plan, interpret mode)
on columns without exceptions and without a tail in all four routes, and
against a numpy mirror of the whole input on every route column.
``tests/test_torch_cuda.py`` holds K17 against the plain version on the
card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from alp_tpu import container as jcontainer
from alp_tpu import engine as jengine
from alp_tpu.kernels import decode as jdecode

import alp_tpu_torch
from alp_tpu_torch import engine
from alp_tpu_torch.kernels import keys as kkeys
from alp_tpu_torch.ops.keys import bias
from test_torch_query import NAMES, _column

CPU = {"device": "cpu"}
METHODS = ("linear", "lower", "higher", "midpoint", "nearest")
QS = np.array((0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
JAX_NAMES = ["bw0_zeros", "bw_le32", "bw_53_64", "f64_rd", "f32_alp",
             "f32_rd"]
_CACHE = {}


def _bits(x: np.ndarray) -> np.ndarray:
    return x.view(f"u{x.dtype.itemsize}")


def _keys(x: np.ndarray) -> np.ndarray:
    """numpy total-order keys (-0.0 as +0.0)."""
    b = _bits(x)
    sbit = b.dtype.type(1) << b.dtype.type(8 * b.itemsize - 1)
    b = np.where(b == sbit, b.dtype.type(0), b)
    return np.where((b & sbit) != 0, ~b, b | sbit)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(_bits(a), _bits(b)))


def _equals_numpy(got, x, q, method, by_value=False) -> bool:
    """``got`` against ``np.quantile(x, q, method)`` in the column dtype:
    NaN by ``isnan``, else by bits (or by ``==`` with ``by_value``)."""
    want = np.asarray(np.quantile(x, q, method=method)).astype(x.dtype)
    got = np.asarray(got)
    if got.dtype != x.dtype or got.shape != want.shape:
        return False
    nan = np.isnan(want)
    if not np.array_equal(np.isnan(got), nan):
        return False
    if by_value:
        return bool(np.all(got[~nan] == want[~nan]))
    return np.array_equal(_bits(got[~nan]), _bits(want[~nan]))


def _columns(name: str):
    """(input, JAX column, port column), compressed once."""
    if name not in _CACHE:
        x = _column(name)
        jcol = jcontainer.compress(x)
        _CACHE[name] = (x, jcol, alp_tpu_torch.CompressedColumn.from_bytes(
            jcol.to_bytes()))
    return _CACHE[name]


# ---------------------------------------------------------------------------
# answers against alp_tpu.engine and np.quantile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", JAX_NAMES)
def test_quantile_equals_jax_and_numpy(name):
    x, jcol, col = _columns(name)
    for m in METHODS:
        got = alp_tpu_torch.query_quantile(col, QS, m, **CPU)
        assert _same_bits(got, jengine.query_quantile(jcol, QS, m)), m
        assert _equals_numpy(got, x, QS, m, by_value=name == "bw0_zeros"), m
    if name == "bw0_zeros":
        assert not np.signbit(got).any()         # the zeros' key is +0.0
    median = alp_tpu_torch.query_median(col, **CPU)
    assert type(median) is x.dtype.type
    assert _same_bits(median, alp_tpu_torch.query_quantile(col, 0.5, **CPU))
    assert _equals_numpy(median, x, 0.5, "linear",
                         by_value=name == "bw0_zeros")


@pytest.mark.parametrize("name", ["bw_le32", "f32_rd"])
def test_median_equals_jax(name):
    _, jcol, col = _columns(name)
    assert _same_bits(alp_tpu_torch.query_median(col, **CPU),
                      jengine.query_median(jcol))


@pytest.mark.parametrize("name", [n for n in NAMES if n not in JAX_NAMES])
def test_quantile_equals_numpy(name):
    x = _column(name)
    col = alp_tpu_torch.compress(x)
    for m in METHODS:
        assert _equals_numpy(alp_tpu_torch.query_quantile(col, QS, m, **CPU),
                             x, QS, m), m
    assert _equals_numpy(alp_tpu_torch.query_median(col, **CPU), x, 0.5,
                         "linear")


def _case(name: str) -> np.ndarray:
    """The inputs of ``tests/test_quantile.py``, one per case."""
    if name == "f64_exceptions":
        rng = np.random.default_rng(21)
        x = np.round(rng.normal(20.0, 8.0, 6000), 3)
        x[5], x[6] = 1e297, -0.0
        return x
    if name == "duplicates":
        return np.repeat([1.5, 2.5, 2.5, 7.0], 500)
    if name == "constant":
        return np.full(2048, 42.25)
    if name.startswith("n="):
        n = int(name[2:])
        return np.round(np.random.default_rng(22 + n).normal(0.0, 50.0, n), 2)
    if name == "rd":
        return np.random.default_rng(23).normal(48.8, 0.4, 4096)
    if name == "f32":
        rng = np.random.default_rng(24)
        return np.round(rng.normal(5.0, 2.0, 5000), 2).astype(np.float32)
    if name == "infinities":
        x = np.round(np.random.default_rng(25).normal(0.0, 3.0, 3000), 2)
        x[0], x[1] = np.inf, -np.inf
        return x
    if name == "nan":
        x = np.arange(100, dtype=np.float64)
        x[3] = np.nan
        return x
    if name.startswith("median="):
        n = int(name[7:])
        return np.round(np.random.default_rng(26 + n).normal(100.0, 30.0, n),
                        3)
    raise KeyError(name)


CASES = ["f64_exceptions", "duplicates", "constant", "n=1", "n=2", "n=3",
         "n=100", "n=1025", "rd", "f32", "infinities", "nan", "median=9",
         "median=10", "median=4999", "median=5000"]


@pytest.mark.parametrize("name", CASES)
def test_reference_cases_equal_numpy(name):
    """Every method at QS and at three scalars against numpy, the median
    against ``np.quantile(x, 0.5)`` (and ``np.median`` on the f64 cases of
    ``test_median_matches_numpy``).  With an infinity numpy's ``_lerp`` gives
    NaN even at an exact rank (inf * 0); there the port, as the JAX package
    (``test_quantile_infinities_no_nan``), returns the value at the rank, so
    the endpoints of that case are held to -inf and +inf."""
    x = _case(name)
    col = alp_tpu_torch.compress(x)
    inner = QS[1:-1] if name == "infinities" else QS
    for m in METHODS:
        got = alp_tpu_torch.query_quantile(col, QS, m, **CPU)
        if m in ("lower", "higher", "nearest") or name != "infinities":
            assert _equals_numpy(got, x, QS, m), m
        else:
            assert _equals_numpy(got[1:-1], x, inner, m), m
            assert got[0] == -np.inf and got[-1] == np.inf
        for q in (0.0, 0.5, 1.0):                # scalars
            got = alp_tpu_torch.query_quantile(col, q, m, **CPU)
            assert type(got) is x.dtype.type
            assert _same_bits(got, alp_tpu_torch.query_quantile(
                col, [q], m, **CPU)[0]), (m, q)
    median = alp_tpu_torch.query_median(col, **CPU)
    assert type(median) is x.dtype.type
    assert _equals_numpy(median, x, 0.5, "linear")
    if name.startswith("median="):
        assert median == np.median(x)


def test_empty_column_gives_nan_as_jax():
    x = np.zeros(0)
    jcol = jcontainer.compress(x)
    col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
    got = alp_tpu_torch.query_quantile(col, QS, **CPU)
    assert got.shape == QS.shape and np.isnan(got).all()
    assert _same_bits(got, jengine.query_quantile(jcol, QS))
    scalar = alp_tpu_torch.query_quantile(col, 0.5, **CPU)
    assert type(scalar) is np.float64 and np.isnan(scalar)
    assert np.isnan(alp_tpu_torch.query_median(col, **CPU))


# ---------------------------------------------------------------------------
# the bisection: exact rank keys, chunks of ranks, passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_rank_keys_equal_a_sort(name):
    """The exact key at ranks spread over the whole column (NaN keys of both
    signs included) and the NaN counts, against a numpy sort."""
    x = _column(name)
    col = alp_tpu_torch.compress(x)
    k = np.sort(_keys(x))
    ranks = sorted({1, 2, len(x) // 3, len(x) // 2 + 1, len(x) - 1,
                    len(x)} - {0})
    keys, negnan, posnan = engine._select_rank_keys(col, col.plan("cpu"),
                                                    ranks)
    assert keys == {r: int(k[r - 1]) for r in ranks}
    sbit = 1 << (8 * x.itemsize - 1)
    assert negnan == int(np.sum(np.isnan(x) & ((_bits(x) & sbit) != 0)))
    assert posnan == int(np.sum(np.isnan(x) & ((_bits(x) & sbit) == 0)))


def _spread_ranks(n: int, R: int) -> list:
    """R distinct 1-based ranks over n values, in pairs of neighbours as
    quantiles that fall between two ranks ask for them."""
    pairs = np.linspace(1, n - 1, -(-R // 2)).astype(np.int64)
    ranks = sorted({int(r) for b in pairs for r in (b, b + 1)})[:R]
    assert len(ranks) == R
    return ranks


@pytest.mark.parametrize("R", (20, 32, 33))
@pytest.mark.parametrize("name", ["bw_le32", "bw_53_64", "f32_rd"])
def test_wide_rank_selections_equal_a_sort(name, R):
    """Up to ``MAX_RANKS`` (32) ranks are one bisection that closes within
    ``rank_pass_bound``; one rank more makes two."""
    x = _column(name)
    col = alp_tpu_torch.compress(x)
    k = np.sort(_keys(x))
    ranks = _spread_ranks(len(x), R)
    keys, _, _ = engine._select_rank_keys(col, col.plan("cpu"), ranks)
    assert keys == {r: int(k[r - 1]) for r in ranks}
    assert engine.LAST_RANK_BISECTIONS == (1 if R <= kkeys.MAX_RANKS else 2)
    bound = sum(engine.rank_pass_bound(8 * x.itemsize,
                                       min(kkeys.MAX_RANKS, R - s))
                for s in range(0, R, kkeys.MAX_RANKS))
    assert engine.LAST_RANK_BISECTIONS <= engine.LAST_RANK_PASSES <= bound


@pytest.mark.parametrize("name", ["bw_le32", "bw_33_52", "f32_rd"])
def test_ranks_past_one_chunk(name):
    """41 quantiles: 41 to 80 ranks, so two or three chunks of
    ``MAX_RANKS``, each its own bisection of one pass or more; on the CPU
    no kernel launches."""
    x = _column(name)
    col = alp_tpu_torch.compress(x)
    qs = np.linspace(0.0, 1.0, 41)
    for m in METHODS:
        kkeys.reset_launches()
        got = alp_tpu_torch.query_quantile(col, qs, m, **CPU)
        assert _equals_numpy(got, x, qs, m), m
        assert engine.LAST_RANK_BISECTIONS >= 2
        assert engine.LAST_RANK_PASSES >= engine.LAST_RANK_BISECTIONS
        assert kkeys.LAUNCHES["rank_pass"] == 0


@pytest.mark.parametrize("name, n_q", [
    pytest.param(name, n_q, id=name if n_q is None else f"{name}-{n_q}q")
    for n_q in (None, 10, 16) for name in ("bw_53_64", "f32_rd")])
def test_passes_stay_within_the_bound(name, n_q):
    """High-entropy keys (integers over all of int64; f32 normal times
    1e8): each chunk closes within ``rank_pass_bound``; ten and sixteen
    quantiles (20 and 32 ranks) are one bisection."""
    x = _column(name)
    col = alp_tpu_torch.compress(x)
    width = 8 * x.itemsize
    lists = ((0.5, [0.1, 0.5, 0.9], np.linspace(0, 1, 9)) if n_q is None
             else (np.linspace(0.01, 0.99, n_q),))
    for q in lists:
        got = alp_tpu_torch.query_quantile(col, q, **CPU)
        assert _equals_numpy(got, x, q, "linear")
        n_ranks = 2 * np.size(q)
        bound = sum(engine.rank_pass_bound(width, min(kkeys.MAX_RANKS,
                                                      n_ranks - s))
                    for s in range(0, n_ranks, kkeys.MAX_RANKS))
        assert 1 <= engine.LAST_RANK_PASSES <= bound, (q, bound)
        if n_q is not None:
            assert engine.LAST_RANK_BISECTIONS == 1


def test_too_many_passes_raise(monkeypatch):
    col = alp_tpu_torch.compress(_column("bw_53_64"))
    monkeypatch.setattr(engine, "rank_pass_bound", lambda width, R: 0)
    with pytest.raises(RuntimeError, match="still open"):
        alp_tpu_torch.query_quantile(col, 0.5, **CPU)
    monkeypatch.setattr(engine, "rank_pass_bound", lambda width, R: 1)
    with pytest.raises(RuntimeError, match="still open"):
        alp_tpu_torch.query_median(col, **CPU)


def test_key_extent_is_kept_on_the_plan(monkeypatch):
    """The first QUANTILE takes the key extent from K16 and keeps it on the
    plan; the next ones start from it without a K16 pass."""
    x = _column("bw_le32")
    col = alp_tpu_torch.compress(x)
    plan = col.plan("cpu")
    assert plan.key_extent is None
    first = alp_tpu_torch.query_median(col, **CPU)
    k = _keys(x)
    assert plan.key_extent == (int(k.min()), int(k.max()))
    assert engine.key_extent(plan) == plan.key_extent

    def refuse(plan):
        raise AssertionError("K16 ran again")
    monkeypatch.setattr(engine, "vector_extremes", refuse)
    assert _same_bits(alp_tpu_torch.query_median(col, **CPU), first)


def test_min_max_and_quantile_share_the_kept_key_extent(monkeypatch):
    """MIN and MAX keep the key extent on the plan as QUANTILE does: after
    the first MIN neither MAX nor a QUANTILE runs K16 again."""
    x = _column("specials")
    col = alp_tpu_torch.compress(x)
    k = _keys(x)
    want = (int(k.min()), int(k.max()))
    assert _same_bits(alp_tpu_torch.query_min(col, **CPU),
                      engine._key_float(want[0], x.dtype))
    assert col.plan("cpu").key_extent == want

    def refuse(plan):
        raise AssertionError("K16 ran again")
    monkeypatch.setattr(engine, "vector_extremes", refuse)
    assert _same_bits(alp_tpu_torch.query_max(col, **CPU),
                      engine._key_float(want[1], x.dtype))
    alp_tpu_torch.query_quantile(col, (0.1, 0.9), **CPU)


# ---------------------------------------------------------------------------
# validation, scalars and the default device
# ---------------------------------------------------------------------------

def test_bad_quantiles_and_methods_raise_as_jax():
    x, jcol, col = _columns("bw_le32")
    for q in (1.5, -0.1, np.nan, [0.5, np.nan], [0.2, 1.01]):
        with pytest.raises(ValueError, match=r"in \[0, 1\]"):
            alp_tpu_torch.query_quantile(col, q, **CPU)
        with pytest.raises(ValueError, match=r"in \[0, 1\]"):
            jengine.query_quantile(jcol, q)
    with pytest.raises(ValueError, match="unknown interpolation"):
        alp_tpu_torch.query_quantile(col, QS, "cubic", **CPU)
    with pytest.raises(ValueError, match="unknown interpolation"):
        jengine.query_quantile(jcol, QS, "cubic")


@pytest.mark.parametrize("name", ["bw_le32", "f32_rd"])
def test_scalar_and_array_shapes_equal_jax(name):
    x, jcol, col = _columns(name)
    for q in (0.5, np.float64(0.5), np.array(0.5)):
        got = alp_tpu_torch.query_quantile(col, q, **CPU)
        want = jengine.query_quantile(jcol, q)
        assert type(got) is type(want) is x.dtype.type
        assert _same_bits(got, want)
    for q in ([0.5], np.array([0.25, 0.75])):
        got = alp_tpu_torch.query_quantile(col, q, **CPU)
        want = jengine.query_quantile(jcol, q)
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        assert _same_bits(got, want)


def test_quantiles_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    col = alp_tpu_torch.compress(np.linspace(0, 1, 3000))
    for kwargs in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            alp_tpu_torch.query_quantile(col, 0.5, **kwargs)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            alp_tpu_torch.query_median(col, **kwargs)


# ---------------------------------------------------------------------------
# K17's plain version against the JAX rank passes and a numpy mirror
# ---------------------------------------------------------------------------

def _unbias(words) -> np.ndarray:
    return (np.asarray(words).astype(np.int64) & 0xFFFFFFFF) ^ 0x80000000


def _jax_rank_pass(jcol, thr: np.ndarray, brackets: list) -> tuple:
    """The JAX rank passes over every group of the JAX plan, joined as the
    JAX engine's bisection joins them (``engine.py:3418-3458``): per-lane
    prefix counts summed, the pad vectors' lanes of each group's last row
    masked, the per-lane (hi, lo) key words merged lexicographically.
    Returns (#{key <= thr}, [(least, largest)] a bracket)."""
    plan = jcol.plan()
    f32 = jcol.dtype == np.float32
    kt = np.uint32 if f32 else np.uint64
    per, lanes, rows_pr = (4, 32, 2) if f32 else (8, 16, 4)
    T, R = len(thr), len(brackets)
    E_pad, M_pad = -(-T // 8) * 8, -(-(R * rows_pr) // 8) * 8
    thrs = np.concatenate([thr, np.full(E_pad - T, thr[-1], kt)])
    br = np.asarray(brackets, kt)

    def words(a):
        return [(a >> np.uint64(32)).astype(np.uint32),
                (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)]

    def planes(v, rows):
        return jnp.asarray(np.broadcast_to(np.asarray(v, np.uint32)[:, None],
                                           (rows, 128)))

    if f32:
        thr_hi = thr_lo = planes(thrs, E_pad)
        brv = br.reshape(-1)
    else:
        th, tl = words(thrs)
        thr_hi, thr_lo = planes(th, E_pad), planes(tl, E_pad)
        brv = np.stack(words(br[:, 0]) + words(br[:, 1]), 1).reshape(-1)
    brv = np.concatenate([brv.astype(np.uint32),
                          np.zeros(M_pad - len(brv), np.uint32)])
    counts = np.zeros(T, np.int64)
    least, largest = [(1 << 8 * br.itemsize) - 1] * R, [0] * R
    for g in plan.groups:
        pc, mm = jengine._bucket_rankpass(
            g, list(jdecode.group_arrays(g)), thr_hi, thr_lo,
            planes(brv, M_pad), n_thr=T, n_rank=R, f32=f32)
        ok = np.arange(128) < ((g.n_vectors % per or per) * lanes)
        pc = np.array(pc).astype(np.int64)
        pc[-1][:, ~ok] = 0
        counts += pc[:, :T, :].sum(axis=(0, 2))
        mm = np.array(mm)
        for row in range(R * rows_pr):
            low = row % rows_pr < rows_pr // 2
            mm[-1, row, ~ok] = 2 ** 31 - 1 if low else -2 ** 31
        for r in range(R):
            if f32:
                lo = _unbias(mm[:, 2 * r]).min()
                hi = _unbias(mm[:, 2 * r + 1]).max()
            else:
                lo = ((_unbias(mm[:, 4 * r]) << 32)
                      | _unbias(mm[:, 4 * r + 1])).astype(np.uint64).min()
                hi = ((_unbias(mm[:, 4 * r + 2]) << 32)
                      | _unbias(mm[:, 4 * r + 3])).astype(np.uint64).max()
            least[r], largest[r] = min(least[r], int(lo)), max(largest[r],
                                                               int(hi))
    return counts, list(zip(least, largest))


def _port_rank_pass(col, thr: np.ndarray, brackets: list) -> tuple:
    """K17's plain version over every bucket of the port's plan:
    (#{key <= thr}, [(least, largest)] a bracket)."""
    bins, mm = engine.rank_pass_bins(col.plan("cpu"), thr, brackets)
    kt = thr.dtype.type
    return (np.cumsum(bins.numpy())[:-1],
            [tuple(map(int, p)) for p in mm.numpy().view(kt)])


def _probe_case(x: np.ndarray) -> tuple:
    """Thresholds from the column's own keys and between them, and
    brackets: a wide one, one key, an empty one, the whole key space."""
    k = np.sort(_keys(x))
    kt = k.dtype.type
    thr = np.unique(np.concatenate([k[::97], k[5::211] + kt(1)]))
    top = (1 << 8 * k.itemsize) - 1
    brackets = [(int(k[10]), int(k[len(k) // 2])),
                (int(k[len(k) // 3]), int(k[len(k) // 3])),
                (int(k[0]) - 1 if k[0] else 0, int(k[0]) - 1 if k[0] else 0),
                (0, top)]
    return k, thr, brackets


# one column per route, none with exceptions or a tail: the JAX rank passes
# count the slots of exceptions as decoded and the pad, which the engine
# corrects on the host, while K17 writes the exceptions in and skips the pad
RANKPASS_COLUMNS = {
    "alp_f64": lambda rng: np.round(rng.uniform(0, 100, 2048), 1),
    "rd_f64": lambda rng: rng.uniform(1, 2, 2048),
    "alp_f32": lambda rng: rng.integers(-5000, 5000, 2048).astype(np.float32),
    "rd_f32": lambda rng: rng.uniform(1, 2, 2048).astype(np.float32),
}


@pytest.mark.parametrize("route", sorted(RANKPASS_COLUMNS))
def test_k17_plain_equals_the_jax_rank_passes(route):
    x = RANKPASS_COLUMNS[route](np.random.default_rng(3))
    jcol = jcontainer.compress(x)
    assert int(np.sum(jcol.exc_count)) == 0 and len(x) % 1024 == 0
    scheme = {2: "alp", 1: "rd"}[int(jcol.rg_scheme[0])]
    assert route.startswith(scheme)
    col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
    k, thr, brackets = _probe_case(x)
    got = _port_rank_pass(col, thr, brackets)
    want = _jax_rank_pass(jcol, thr, brackets)
    assert np.array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert np.array_equal(got[0], np.searchsorted(k, thr, "right"))


@pytest.mark.parametrize("name", NAMES)
def test_k17_plain_equals_numpy(name):
    """Every bucket of every route column (exceptions, the pad, NaN, +-Inf
    and -0.0 included), and the whole column, against numpy."""
    x = _column(name)
    col = alp_tpu_torch.compress(x)
    plan = col.plan("cpu")
    k, thr, brackets = _probe_case(x)
    kt = k.dtype.type
    thr_t = engine._key_tensor(plan, thr)
    br_t = engine._key_tensor(plan, np.array(brackets, kt))
    top = (1 << 8 * k.itemsize) - 1

    def mirror(keys):
        bins = np.bincount(np.searchsorted(thr, keys, "left"),
                           minlength=len(thr) + 1)
        pairs = []
        for lo, hi in brackets:
            sel = keys[(keys >= kt(lo)) & (keys <= kt(hi))]
            pairs.append((int(sel.min()), int(sel.max())) if sel.size
                         else (top, 0))
        return bins, pairs

    pad = -len(x) % 1024
    full = np.concatenate([_keys(x), np.zeros(pad, kt)]).reshape(-1, 1024)
    for call in engine.key_calls(plan):
        rows = call.rows.numpy()
        real = (rows[:, None] * 1024 + np.arange(1024)) < len(x)
        bins, mm = call.rank_pass_plain(thr_t, br_t)
        want_bins, want_pairs = mirror(full[rows][real])
        assert np.array_equal(bins.numpy(), want_bins)
        assert [tuple(map(int, p)) for p in mm.numpy().view(kt)] == \
            want_pairs
    got = _port_rank_pass(col, thr, brackets)
    want_bins, want_pairs = mirror(k)
    assert np.array_equal(got[0], np.cumsum(want_bins)[:-1])
    assert got[1] == want_pairs


def test_k17_wrappers_check_their_arguments():
    col = alp_tpu_torch.compress(_column("bw_le32"))
    plan = col.plan("cpu")
    call = engine.key_calls(plan)[0]

    def run(T, R, dtype=torch.int64):
        thr = torch.arange(T, dtype=dtype)
        br = torch.zeros((R, 2), dtype=dtype)
        bins, mm = kkeys.rank_outputs(T, R, dtype, "cpu")
        return call.rank_pass(thr, br, bins, mm)

    run(1, 1)
    run(kkeys.MAX_THRESHOLDS, kkeys.MAX_RANKS)
    for T, R in ((0, 1), (kkeys.MAX_THRESHOLDS + 1, 1), (2, 0),
                 (2, kkeys.MAX_RANKS + 1)):
        with pytest.raises(ValueError):
            run(T, R)
    with pytest.raises(TypeError):
        run(2, 1, torch.int32)


# ---------------------------------------------------------------------------
# K17's search tree and bracket masks (csrc/keys.cu), mirrored in torch
# ---------------------------------------------------------------------------

TREE = kkeys.MAX_THRESHOLDS - 1      # csrc/keys.cu kTree


def _tree_mirror(thr: torch.Tensor) -> tuple:
    """``Tree::build``: the first min(T, TREE) unsigned thresholds (held
    signed) in Eytzinger order at nodes 1 .. 2^L - 1, padded with all ones;
    returned as biased keys, with L."""
    n = min(thr.shape[0], TREE)
    L = 0
    while (1 << L) - 1 < n:
        L += 1
    tree = torch.full((1 << L,), -1, dtype=thr.dtype)
    for at in range(1, 1 << L):
        d = at.bit_length() - 1
        s = ((2 * (at - (1 << d)) + 1) << (L - 1 - d)) - 1
        if s < n:
            tree[at] = thr[s]
    return bias(tree), L


def _tree_bins(thr: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """``Tree::bins`` of each biased key: L levels of at = 2 at +
    (tree[at] < key), then at - 2^L, plus the compare with the last
    threshold at T = 2048."""
    tree, L = _tree_mirror(thr)
    at = torch.ones(keys.shape, dtype=torch.int64)
    for _ in range(L):
        at = 2 * at + (tree[at] < keys).to(torch.int64)
    p = at - (1 << L)
    if thr.shape[0] > TREE:
        p += (bias(thr[-1:]) < keys).to(torch.int64)
    return p


def _threshold_case(T: int, f64: bool, seed: int, kind: str = "random"):
    """T ascending distinct unsigned thresholds and probe keys (unsigned
    numpy): seeded random keys, every threshold and its +-1.  ``kind``:
    thresholds spread over the key space, in 8 narrow bands (a later
    bisection pass), or 3 apart."""
    rng = np.random.default_rng(seed)
    ut = np.uint64 if f64 else np.uint32
    top = np.iinfo(ut).max
    if kind == "random":
        thr = np.unique(rng.integers(0, top, 2 * T, dtype=ut, endpoint=True))
    elif kind == "bands":
        lo = np.sort(rng.integers(0, top - (1 << 20), 8, dtype=ut))
        thr = np.unique(np.concatenate([
            b + rng.integers(0, 1 << 20, T, dtype=ut) for b in lo]))
    else:
        thr = ut(rng.integers(0, top // 2)) + np.arange(T, dtype=ut) * ut(3)
    thr = np.sort(rng.choice(thr, T, replace=False))
    keys = np.concatenate([rng.integers(0, top, 4096, dtype=ut,
                                        endpoint=True), thr, thr + ut(1),
                           thr - ut(1), [ut(0), ut(top)]]).astype(ut)
    return thr, keys


def _signed(keys: np.ndarray) -> torch.Tensor:
    """Unsigned numpy keys as the signed words the kernels take."""
    return torch.from_numpy(keys.view(f"i{keys.itemsize}").copy())


@pytest.mark.parametrize("kind", ("random", "bands", "dense"))
@pytest.mark.parametrize("f64", (True, False))
@pytest.mark.parametrize("T", (1, 2, 31, 32, 33, 2047, 2048))
def test_k17_tree_search_equals_searchsorted(T, f64, kind):
    thr, keys = _threshold_case(T, f64, T, kind)
    thr_t, keys_t = _signed(thr), bias(_signed(keys))
    want = torch.searchsorted(bias(thr_t), keys_t, right=False)
    assert torch.equal(_tree_bins(thr_t, keys_t), want)


def _cut_tables(thr: torch.Tensor, brackets: torch.Tensor) -> tuple:
    """K17's bracket tables (``rank_pass_kernel``), from unsigned
    thresholds and [R, 2] unsigned brackets held signed, as biased keys:
    the cut points (lo - 1 and hi of each distinct bracket that holds a
    key, ascending), each cut interval's bracket mask, and each bin's
    first interval and the number of cuts that split it."""
    dt = thr.dtype
    top, bottom = torch.iinfo(dt).max, torch.iinfo(dt).min
    br = bias(brackets)
    uniq = []
    for lo, hi in br.tolist():
        if lo <= hi and (lo, hi) not in uniq:
            uniq.append((lo, hi))
    cuts = sorted({c for lo, hi in uniq for c, keep in
                   ((lo - 1, lo > bottom), (hi, hi < top)) if keep})
    ct = torch.tensor(cuts, dtype=dt)
    pairs = [tuple(x) for x in br.tolist()]
    masks = []
    for q in range(len(cuts) + 1):
        lower = bottom if q == 0 else cuts[q - 1] + 1
        upper = top if q == len(cuts) else cuts[q]
        masks.append(sum(1 << r for r, (lo, hi) in enumerate(pairs)
                         if pairs.index((lo, hi)) == r and lo <= hi
                         and lower >= lo and upper <= hi))
    b = bias(thr)
    lower = torch.cat([torch.tensor([bottom], dtype=dt),
                       torch.where(b < top, b + 1, b)])
    upper = torch.cat([b, torch.tensor([top], dtype=dt)])
    ql = torch.searchsorted(ct, lower)
    qu = torch.searchsorted(ct, upper)
    return ct, torch.tensor(masks), ql, torch.where(lower <= upper,
                                                    qu - ql, 0)


@pytest.mark.parametrize("f64", (True, False))
def test_k17_cut_intervals_give_each_keys_brackets(f64):
    """A key's bin gives its cut interval (the bin's first one, plus the
    cuts inside the bin below the key), and the interval's mask is exactly
    the brackets that hold the key (the first of equal brackets): brackets
    that overlap, hold one key, none, lie reversed, or span every key."""
    thr_u, keys_u = _threshold_case(64, f64, 3)
    thr, keys = _signed(thr_u), bias(_signed(keys_u))
    st = thr.dtype
    pick = torch.sort(bias(keys)[torch.randperm(
        keys.shape[0], generator=torch.Generator().manual_seed(4))[:6]]
    ).values
    top, bottom = torch.iinfo(st).max, torch.iinfo(st).min
    ends = torch.tensor([bottom, top], dtype=st)
    brackets = bias(torch.stack(
        [torch.cat([pick[[0, 1, 2, 3, 5, 0]], ends[:1]]),
         torch.cat([pick[[2, 4, 2, 3, 4, 2]], ends[1:]])], 1))
    _assert_cut_intervals(thr, keys, brackets)


@pytest.mark.parametrize("f64", (True, False))
def test_k17_cut_intervals_of_32_brackets(f64):
    """As above at ``MAX_RANKS`` = 32 brackets, a later pass's: 16
    disjoint, one equal to the first, and 15 that overlap them and each
    other; up to 64 cuts, and bracket 31 in bit 31 of the masks."""
    thr_u, keys_u = _threshold_case(2048, f64, 5)
    thr, keys = _signed(thr_u), bias(_signed(keys_u))
    ends = torch.sort(bias(keys)[torch.randperm(
        keys.shape[0], generator=torch.Generator().manual_seed(6))[:32]]
    ).values
    pairs = ([(2 * i, 2 * i + 1) for i in range(16)] + [(0, 1)]
             + [(2 * i + 1, min(2 * i + 4, 31)) for i in range(15)])
    brackets = bias(ends[torch.tensor(pairs)])
    assert brackets.shape[0] == kkeys.MAX_RANKS
    _assert_cut_intervals(thr, keys, brackets)


def _assert_cut_intervals(thr, keys, brackets) -> None:
    """Each biased key's cut interval, from its bin, and that interval's
    mask, against ``torch.searchsorted`` and the brackets themselves."""
    ct, masks, first, cuts = _cut_tables(thr, brackets)
    p = _tree_bins(thr, keys)
    q = first[p].clone()
    for c in range(int(cuts.max())):          # the cuts inside the bin
        inside = c < cuts[p]
        at = torch.clamp(first[p] + c, max=ct.shape[0] - 1)
        q += (inside & (ct[at] < keys)).to(torch.int64)
    assert torch.equal(q, torch.searchsorted(ct, keys))
    got = masks[q]
    br = bias(brackets).tolist()
    want = torch.zeros_like(got)
    for r, (lo, hi) in enumerate(br):
        if [tuple(x) for x in br].index((lo, hi)) == r:
            want |= (((keys >= lo) & (keys <= hi)).to(torch.int64) << r)
    assert torch.equal(got, want)
