"""The share path of ``alp_tpu_torch.parallel`` over gloo on the CPU: each
rank compresses only its own rows and queries its ``ColumnShare``.

Ranks are spawned once per world size (1, 2 and 4) by
``torch_parallel_worker.spawn_ranks`` running ``run_share_rank`` on the six
route columns of ``torch_parallel_worker.columns`` (f64 ALP, f64 ALP_RD,
mixed ALP / ALP_RD, f32 ALP, f32 ALP_RD, NaN / +-Inf / -0.0 with a partial
last vector; 2.5 rowgroups, so that rank 0 of four holds none):

* ``share_sum``, ``share_mean``, ``share_filter_count`` and
  ``share_filter_sum`` equal, by bits, ``engine.query_sum``,
  ``query_mean``, ``query_filter_count`` and ``query_filter_sum`` of the
  whole column on one device, and ``math.fsum``, the exact mean rounded
  once (``Fraction``), or a count from numpy;
* a share off a rowgroup boundary, over the share before it, leaving a
  gap, or of another length or dtype than the others' is refused on every
  rank alike;
* the MEAN and SUM WHERE joins of synthetic SUM rows near 2^62 equal their
  Python-integer sums, where an int64 all-reduce would wrap.

This file imports neither JAX nor ``alp_tpu``.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import alp_tpu_torch
from alp_tpu_torch import engine
from alp_tpu_torch.kernels import exact_sum as kes

import torch_parallel_worker as worker

WORLDS = (1, 2, 4)
COLUMNS = worker.columns()
B = 1074                     # finite doubles are integers times 2^-1074
REFUSED = {"off_boundary": "off a rowgroup boundary", "overlap": "overlap",
           "gap": "a gap", "length": "disagree", "dtype": "disagree"}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    out = worker.spawn_ranks(world, "cpu",
                             str(tmp_path_factory.mktemp(f"share{world}")),
                             deadline=240.0, target=worker.run_share_rank)
    assert [r["rank"] for r in out] == list(range(world))
    return out


@pytest.fixture(scope="module")
def one_card():
    """``engine.query_*`` of every whole column on one device."""
    out = {}
    for name, x in COLUMNS.items():
        col = alp_tpu_torch.compress(x)
        rng = worker.share_range(x)
        out[name] = {
            "sum": engine.query_sum(col, device="cpu"),
            "mean": engine.query_mean(col, device="cpu"),
            "count": engine.query_filter_count(col, *rng, device="cpu"),
            "filter_sum": engine.query_filter_sum(col, *rng, device="cpu"),
        }
    return out


def _bits(v) -> tuple:
    """A float's type and bits; every NaN one point."""
    f = float(v)
    return type(v).__name__, (-1 if math.isnan(f)
                              else np.float64(f).view(np.uint64).item())


def _exact_total(x: np.ndarray) -> int:
    """The exact sum of the finite values of ``x`` in units of 2^-1074."""
    f = x[np.isfinite(x)].astype(np.float64)
    mant, exp = np.frexp(f)
    ints = (mant * 2.0 ** 53).astype(np.int64)
    total = 0
    for e in np.unique(exp).tolist():
        total += sum(ints[exp == e].tolist()) << (e - 53 + B)
    return total


def _special(x: np.ndarray):
    """NaN, +Inf or -Inf where IEEE gives one to a sum of ``x``, else
    None."""
    pinf, ninf = bool(np.isposinf(x).any()), bool(np.isneginf(x).any())
    if np.isnan(x).any() or (pinf and ninf):
        return math.nan
    if pinf or ninf:
        return math.inf if pinf else -math.inf
    return None


def _exact_mean(x: np.ndarray) -> float:
    odd = _special(x)
    if odd is not None:
        return odd
    total = _exact_total(x)
    return 0.0 if total == 0 else float(Fraction(total, len(x) << B))


def _selected(x: np.ndarray) -> np.ndarray:
    dt = x.dtype.type
    lo, hi = worker.share_range(x)
    return x[(x >= dt(lo)) & (x <= dt(hi))]


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_share_sum_equals_query_sum_and_fsum(ranks, one_card, name):
    fsum = worker.fsum_reference(COLUMNS[name])
    for r in ranks:
        got = r["sum"][name]
        assert _bits(got) == _bits(one_card[name]["sum"]), r["rank"]
        assert _bits(got) == _bits(fsum), r["rank"]


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_share_mean_equals_query_mean_and_the_exact_mean(ranks, one_card,
                                                         name):
    want = _exact_mean(COLUMNS[name])
    for r in ranks:
        got = r["mean"][name]
        assert _bits(got) == _bits(one_card[name]["mean"]), r["rank"]
        assert _bits(got) == _bits(want), r["rank"]


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_share_filter_count_equals_query_filter_count(ranks, one_card, name):
    want = len(_selected(COLUMNS[name]))
    for r in ranks:
        assert r["count"][name] == one_card[name]["count"] == want, r["rank"]


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_share_filter_sum_equals_query_filter_sum_and_fsum(ranks, one_card,
                                                           name):
    x = COLUMNS[name]
    want = x.dtype.type(worker.fsum_reference(_selected(x)))
    for r in ranks:
        got = r["filter_sum"][name]
        assert _bits(got) == _bits(one_card[name]["filter_sum"]), r["rank"]
        assert _bits(got) == _bits(want), r["rank"]


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_share_that_does_not_tile_the_column_is_refused(ranks, case):
    world = len(ranks)
    if worker.refused_share(case, world, 0) is None:
        assert all(case not in r["refused"] for r in ranks)
        return
    for r in ranks:
        why = r["refused"][case]
        assert why is not None, (case, r["rank"])
        assert REFUSED[case] in why, (case, why)
    assert len({r["refused"][case] for r in ranks}) == 1


def test_mean_and_filter_sum_joins_do_not_wrap(ranks):
    width = kes.WINDOWS[torch.int64] + 3
    rows = np.concatenate([worker.near_rows(r, width)
                           for r in range(len(ranks))])
    W = width - 3
    total = sum(int(t) << (32 * w) for row in rows.tolist()
                for w, t in enumerate(row[:W]))
    with np.errstate(over="ignore"):
        wrapped = rows[:, :W].sum(0)
    exact = [sum(int(t) for t in rows[:, w]) for w in range(W)]
    assert any(int(a) != b for a, b in zip(wrapped, exact))
    mean = float(Fraction(total, worker.JOIN_N << 1075))
    fsum = np.float64(float(Fraction(total, 1 << 1075)))
    for r in ranks:
        assert _bits(r["join_mean"]) == _bits(mean)
        assert _bits(r["join_filter_sum"]) == _bits(fsum)
