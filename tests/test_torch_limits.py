"""The limits phase of ``chip_smoke.py`` at a small size, on the CPU.

That phase runs the port on columns of more than 2^31 values, made by
tiling a column of whole rowgroups in compressed form
(``columns.tile_column`` with a tail), against references computed from
the source column alone (``chip_smoke.TiledInput``), and GROUP-BY at 2^24
groups against numpy with every group of at most two values summed by one
IEEE add (``chip_smoke.pair_sums``).  Here a 3-rowgroup column is tiled 5
times with a tail, the input is made, and every reference helper is held
against ``math.fsum``, ``np.quantile``, ``np.histogram`` and numpy's sort
of it; the port's answers on the tiled column (``device="cpu"``: the
kernels' plain versions) must equal the references by bits, as on the
card, also with DISTINCT sorted in small chunks and the cell ids of the
512-row windows made a few vectors at a time.  ``pair_sums`` is held
against ``Fraction`` sums.
"""

import importlib.util
import math
import pathlib
from fractions import Fraction

import numpy as np
import pytest

import alp_tpu_torch
from alp_tpu_torch import engine
from alp_tpu_torch.columns import route_columns, tile_column

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

RG = 100 * 1024                  # values of a rowgroup
COPIES = 5
TAIL = RG + 333                  # the prefix after the copies: a tail
TUMBLING = 250_000               # cells that wrap around the copies
NAMES = ("bench_bw11_city_temperature", "f64_alp_rd", "f32_alp",
         "f64_specials")
_CACHE = {}


def _source(name: str) -> np.ndarray:
    """A column of 3 whole rowgroups (the specials column without its
    tail)."""
    cols = route_columns(np.random.default_rng(20), 300)
    if name == "f64_specials":
        return cols["f64_specials_tail"][:3 * RG].copy()
    return cols[name]


def _case(name: str):
    """(source b, the tiled column, the whole input, its TiledInput)."""
    if name not in _CACHE:
        b = _source(name)
        n = COPIES * len(b) + TAIL
        col = tile_column(alp_tpu_torch.compress(b), -(-n // 1024), n)
        x = np.concatenate([np.tile(b, COPIES), b[:TAIL]])
        _CACHE[name] = (b, col, x, cs.TiledInput(b, n))
    return _CACHE[name]


def test_tile_column_with_a_tail_decodes_to_the_tiled_input():
    b, col, x, _ = _case("bench_bw11_city_temperature")
    assert col.n_values == len(x) and col.n_values % 1024
    got = alp_tpu_torch.decompress(col, device="cpu").numpy()
    assert np.array_equal(got.view(np.uint64), x.view(np.uint64))
    with pytest.raises(ValueError):
        tile_column(alp_tpu_torch.compress(b), 10, 10 * 1024 + 1)
    with pytest.raises(ValueError):
        tile_column(alp_tpu_torch.compress(b), 10, 9 * 1024)


@pytest.mark.parametrize("name", NAMES)
def test_references_equal_numpy_on_the_made_input(name):
    b, _, x, ref = _case(name)
    n = len(x)
    assert (ref.T, ref.r, ref.n) == (COPIES, TAIL, n)
    keys = np.sort(cs.np_keys(x))
    for i in (0, 1, n // 5, n // 2, n - 2, n - 1):
        assert ref.key_at(i) == keys[i]
    for lo, hi in ((ref.value_at(n // 5), ref.value_at(3 * n // 5)),
                   (-math.inf, math.inf), (5.0, -5.0)):
        assert ref.count(lo, hi) == cs.key_count(keys, lo, hi, x.dtype)
    for largest in (True, False):
        for k in (1, 128, 5000):
            want = keys[::-1][:k] if largest else keys[:k]
            assert cs.same_answer(ref.topk(k, largest), cs.values_of_keys(
                want.copy(), x.dtype), "array")
    fin = x[np.isfinite(x)]
    edges = np.linspace(float(fin.min()) - 1, float(fin.max()) + 1, 16)
    assert np.array_equal(ref.histogram(edges),
                          np.histogram(x[~np.isnan(x)],
                                       edges.astype(x.dtype))[0])
    for q in cs.LIMIT_QS + (0.1, 0.75):
        want = np.quantile(x, q)
        assert cs.same_quantile(np.array(ref.quantile(q), x.dtype),
                                np.array(want), x.dtype), q
    total, sp = ref.exact()
    assert cs.same_float(cs.rounded(total, sp, n, x.dtype, False),
                         float(x.dtype.type(cs.fsum_reference(x))))
    assert cs.same_float(cs.rounded(total, sp, n, x.dtype, True),
                         float(x.dtype.type(cs.exact_mean_reference(x))))
    lo, hi = ref.value_at(n // 2), ref.value_at(6 * n // 10)
    k = cs.np_keys(x)
    sel = x[(k >= k.dtype.type(cs.key_of(lo, x.dtype)))
            & (k <= k.dtype.type(cs.key_of(hi, x.dtype)))]
    assert cs.same_float(cs.rounded(*ref.exact(lo, hi), 0, x.dtype, False),
                         float(x.dtype.type(cs.fsum_reference(sel))))
    assert cs.distinct_reference(ref.kb, x.dtype) == (
        len(np.unique(x[~np.isnan(x)])) + int(np.isnan(x).any()))
    bounds = sorted([0, 1000, TUMBLING, 2 * TUMBLING + 17, len(b) + 5,
                     3 * len(b) + 7, n - 1, n])
    win = ref.windows(bounds)
    for g in range(len(bounds) - 1):
        part = x[bounds[g]:bounds[g + 1]]
        assert win["count"][g] == len(part)
        pk = np.sort(cs.np_keys(part))
        assert cs.same_float(float(win["min"][g]),
                             float(cs.values_of_keys(pk[:1], x.dtype)[0]))
        assert cs.same_float(float(win["max"][g]),
                             float(cs.values_of_keys(pk[-1:], x.dtype)[0]))
        s, mean, _ = win["checked"][g]
        assert cs.same_float(s, float(x.dtype.type(cs.fsum_reference(part))))
        assert cs.same_float(mean, float(x.dtype.type(
            cs.exact_mean_reference(part))))
    hop = cs.LIMIT_CELLS
    cells = ref.cells(hop)
    assert len(cells["count"]) == -(-n // hop) and not cells["checked"]
    for g in range(len(cells["count"])):
        part = x[g * hop:(g + 1) * hop]
        assert cells["count"][g] == len(part)
        pk = cs.np_keys(part)
        for a, k in (("min", pk.min()), ("max", pk.max())):
            assert cs.same_float(float(cells[a][g]), float(
                cs.values_of_keys(np.array([k]), x.dtype)[0])), (a, g)
        assert cs.same_float(float(cells["sum"][g]),
                             float(x.dtype.type(cs.fsum_reference(part))))
        assert cs.same_float(float(cells["mean"][g]), float(x.dtype.type(
            cs.exact_mean_reference(part))))


@pytest.mark.parametrize("name", NAMES)
def test_port_on_the_tiled_column_equals_the_references(name):
    """The limits phase's queries, the port on the CPU."""
    b, col, x, ref = _case(name)
    for label, call, want, kind in cs.limit_queries(ref, TUMBLING):
        got = call(alp_tpu_torch, col, "cpu")
        cs.limit_answer_ok(f"{name}: {label}", got, want, kind, x.dtype)


@pytest.mark.parametrize("name", NAMES)
def test_distinct_in_chunks_equals_numpy(name, monkeypatch):
    """DISTINCT sorted in chunks that do not line up with the copies, the
    rowgroups or the vectors, joined across them, equals numpy's count
    (-0.0 equal to 0.0, every NaN one value)."""
    _, col, x, ref = _case(name)
    want = len(np.unique(x[~np.isnan(x)])) + int(np.isnan(x).any())
    assert cs.distinct_reference(ref.kb, x.dtype) == want
    for chunk in (RG + 1, 1 << 16, len(x)):
        monkeypatch.setattr(engine, "DISTINCT_CHUNK", chunk)
        assert alp_tpu_torch.query_distinct(col, device="cpu") == want


@pytest.mark.parametrize("name", NAMES)
def test_cells_made_in_steps_equal_the_references(name, monkeypatch):
    """Tumbling cells of LIMIT_CELLS rows cross every full vector; their
    ids, made a few vectors at a time (``engine._CELL_CHUNK``), give every
    cell's exact answer."""
    _, col, x, ref = _case(name)
    monkeypatch.setattr(engine, "_CELL_CHUNK", 7)
    got = alp_tpu_torch.query_window(col, cs.LIMIT_CELLS, device="cpu")
    cs.check_group_answer(name, got, ref.cells(cs.LIMIT_CELLS), x.dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pair_sums_equal_exact_sums(dtype):
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 4, 2000)
    xs = np.round(rng.uniform(-1e3, 1e3, int(counts.sum())), 2).astype(dtype)
    xs[:50] = -xs[50:100]                      # pairs that cancel
    xs[100:110] = -0.0
    bounds = np.concatenate([[0], np.cumsum(counts)])
    ids, s, mean = cs.pair_sums(xs, bounds, counts, dtype)
    assert np.array_equal(ids, np.flatnonzero(counts <= 2))
    for j, g in enumerate(ids.tolist()):
        part = xs[bounds[g]:bounds[g + 1]]
        exact = sum((Fraction(float(v)) for v in part), Fraction(0))
        want_s = float(dtype(float(exact)))
        assert cs.same_float(float(s[j]), want_s) and not (
            s[j] == 0 and np.signbit(s[j]))
        if len(part):
            want_m = float(dtype(float(exact / len(part))))
            assert cs.same_float(float(mean[j]), want_m)
        else:
            assert math.isnan(mean[j])
