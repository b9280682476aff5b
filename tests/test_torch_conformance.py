"""Fault F3: GROUP-BY and windows over a group with NaN or an infinity
beside finite values whose exact sum passes DBL_MAX.

The JAX package decides such a group by its NaN and infinity counts alone
(``alp_tpu/engine.py`` ``_finish_sum``: NaN, or +Inf with -Inf, gives NaN;
an infinity wins otherwise), and never divides its finite total.  The port
divided first, and raised ``OverflowError``.  Columns made from a seed
with numpy (``torch_parallel_worker.f3_column``: every row of a special
group large, which makes ALP_RD rowgroups, or four rows, ALP exceptions)
are compressed by the JAX package and read by the port from the same ALPT
bytes; ``query_groupby`` (at G = 1, 5 and 300, the reference asked twice
with the same keys object, so that it answers by its MXU pass and its
sorted path), ``query_window`` (tumbling and sliding) and
``parallel.sharded_groupby`` (gloo, world sizes 1 and 2) of the port on
the CPU must equal the JAX package's answers by bits (tolerance 0; NaN
equals NaN).  A finite group past DBL_MAX raises ``OverflowError`` in both
packages.
"""

import numpy as np
import pytest

from alp_tpu import container as jcontainer
from alp_tpu import engine as jengine

import alp_tpu_torch
from alp_tpu_torch import engine
from test_torch_groupby import _same

import torch_parallel_worker as worker

CPU = {"device": "cpu"}
N = 4 * 1024 + 500
KINDS = worker.F3_KINDS
# name -> (what is asked, cells: "random" G ids or rows // hop, G or
# (window, hop), the kind of each cell by its id, dense)
CASES = {}
for _kind in KINDS[1:]:
    for _dense in (True, False):
        CASES[f"groupby_G1_{_kind}_{'dense' if _dense else 'sparse'}"] = (
            "groupby", 1, lambda c, k=_kind: k, _dense)
for _G in (5, 300):
    for _dense in (True, False):
        CASES[f"groupby_G{_G}_{'dense' if _dense else 'sparse'}"] = (
            "groupby", _G, lambda c: KINDS[c % 5], _dense)
for _w, _hop in ((1000, None), (1000, 250)):
    for _dense in (True, False):
        CASES[f"window_{_w}_{_hop}_{'dense' if _dense else 'sparse'}"] = (
            "window", (_w, _hop), lambda c: KINDS[c % 5], _dense)


def _case(name: str):
    """(input, JAX column, port column, how to ask: ("groupby", keys, G)
    or ("window", window, hop))."""
    what, size, kind_of, dense = CASES[name]
    if what == "groupby":
        cell = np.random.default_rng(size).integers(0, size, N)
        G = size
        ask = ("groupby", cell, G)
    else:
        window, hop = size
        cell = np.arange(N) // (hop or window)
        G = int(cell.max()) + 1
        ask = ("window", window, hop)
    x = worker.f3_column(cell, [kind_of(c) for c in range(G)], dense, G)
    jcol = jcontainer.compress(x)
    col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
    return x, jcol, col, ask


def _outcome(fn):
    """The answer, or the type of the exception raised."""
    try:
        return fn()
    except (OverflowError, ValueError) as e:
        return type(e)


def _agree(got, want) -> bool:
    if isinstance(want, type) or isinstance(got, type):
        return got is want
    return _same(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_f3_special_groups_beside_an_overflowing_sum_equal_jax(name):
    x, jcol, col, ask = _case(name)
    if ask[0] == "groupby":
        _, keys, G = ask
        got = _outcome(lambda: engine.query_groupby(col, keys, G, **CPU))
        wants = [_outcome(lambda: jengine.query_groupby(jcol, keys, G))
                 for _ in range(2)]      # its first route, then the sorted
    else:
        _, window, hop = ask
        got = _outcome(lambda: engine.query_window(col, window, hop=hop,
                                                   **CPU))
        wants = [_outcome(lambda: jengine.query_window(jcol, window,
                                                       hop=hop))]
    for want in wants:
        assert isinstance(want, dict), (name, want)   # the reference answers
        assert _agree(got, want), name
    assert not np.isfinite(got["sum"]).all()


@pytest.mark.parametrize("ask", ["groupby", "window"])
def test_f3_finite_group_past_dbl_max_raises_in_both(ask):
    """No special beside the large values: both packages raise, as
    ``math.fsum`` does."""
    if ask == "groupby":
        cell = np.random.default_rng(5).integers(0, 5, N)
        kinds = ["plain", "nan", "overflow", "pinf", "plain"]
    else:
        cell = np.arange(N) // 1000
        kinds = ["plain", "overflow", "nan", "plain", "plain"]
    x = worker.f3_column(cell, kinds, True, 3)
    jcol = jcontainer.compress(x)
    col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
    if ask == "groupby":
        mine = _outcome(lambda: engine.query_groupby(col, cell, 5, **CPU))
        theirs = _outcome(lambda: jengine.query_groupby(jcol, cell, 5))
    else:
        mine = _outcome(lambda: engine.query_window(col, 1000, **CPU))
        theirs = _outcome(lambda: jengine.query_window(jcol, 1000))
    assert mine is theirs is OverflowError
    means = engine.query_groupby(col, cell, 5, aggs=("mean", "count"), **CPU) \
        if ask == "groupby" else engine.query_window(
            col, 1000, aggs=("mean", "count"), **CPU)
    want = (jengine.query_groupby(jcol, cell, 5, aggs=("mean", "count"))
            if ask == "groupby" else jengine.query_window(
                jcol, 1000, aggs=("mean", "count")))
    assert _same(means, want)


@pytest.fixture(scope="module", params=(1, 2), ids=lambda w: f"world{w}")
def f3_ranks(request, tmp_path_factory):
    world = request.param
    out = worker.spawn_ranks(world, "cpu",
                             str(tmp_path_factory.mktemp(f"f3world{world}")),
                             deadline=240.0, target=worker.run_groupby_rank)
    assert [r["rank"] for r in out] == list(range(world))
    return out


@pytest.fixture(scope="module")
def f3_jax_answers():
    return {name: jengine.query_groupby(jcontainer.compress(x), keys, G)
            for name, (x, keys, G) in worker.f3_groupby_cases().items()}


@pytest.mark.parametrize("name", sorted(worker.f3_groupby_cases()))
def test_f3_sharded_groupby_equals_jax(f3_ranks, f3_jax_answers, name):
    want = f3_jax_answers[name]
    assert np.isnan(want["sum"]).any()
    for r in f3_ranks:
        got = r["groupby"][name]
        assert not isinstance(got, str), (r["rank"], got)
        assert _same(got, want), (r["rank"], name)
