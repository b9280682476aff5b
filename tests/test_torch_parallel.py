"""The port's sharded paths over gloo on the CPU, against the JAX package.

Ranks are spawned once per world size (1, 2, 4 and 8, the sizes of the JAX
package's virtual mesh) by ``torch_parallel_worker.spawn_ranks``, which
runs every sharded path on six route columns (f64 ALP, f64 ALP_RD, mixed
ALP / ALP_RD, f32 ALP, f32 ALP_RD, NaN / +-Inf / -0.0 with a tail) of 2.5
rowgroups; the tests read every rank's results:

* ``compress(x, mesh=...)`` equals ``alp_tpu.container.compress(x)``'s blob
  byte for byte on every rank;
* ``decompress(col, mesh=...)`` and ``sharded_decode`` (float32 too)
  equal ``alp_tpu.container.decompress`` by bits;
* ``sharded_exact_sum`` equals ``alp_tpu.engine.query_sum`` and
  ``math.fsum``, ``sharded_filter_count`` ``alp_tpu.engine.
  query_filter_count``, ``sharded_groupby`` ``alp_tpu.engine.
  query_groupby`` by bits;
* ``sharded_encode_decode_step``'s per-vector outputs equal the JAX step's
  on a ``make_mesh(n)`` of the same size, and its bits a value agree with
  the JAX package's float32 mean within 1e-5;
* the cross-rank join of synthetic int64 SUM rows near 2^62 equals their
  Python-integer sum, where an int64 all-reduce would wrap.

The whole-column entry points cut each rank's share of the column
(``column_share``, a ``ColumnShare``) and run the one body each query has
on a share (``share_decode``, ``share_filter_count``, ``share_sum``,
``share_groupby``); ``tests/test_torch_share.py`` holds those bodies, and
the sharded MEAN and SUM WHERE, on shares that each rank compressed from
its own rows alone.
"""

import math

import jax
import numpy as np
import pytest
import torch

from alp_tpu import container as jcontainer
from alp_tpu import engine as jengine
from alp_tpu.ops.numerics import numerics_for
from alp_tpu.parallel import make_mesh as jax_mesh
from alp_tpu.parallel import sharded_encode_decode_step as jax_step
from alp_tpu_torch.kernels import exact_sum as kes

import torch_parallel_worker as worker

WORLDS = (1, 2, 4, 8)
COLUMNS = worker.columns()


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    out = worker.spawn_ranks(world, "cpu",
                             str(tmp_path_factory.mktemp(f"world{world}")),
                             deadline=240.0)
    assert [r["rank"] for r in out] == list(range(world))
    return out


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX package's blob, decode, SUM, COUNT and GROUP-BY of every
    column (computed once)."""
    out = {}
    for name, x in COLUMNS.items():
        cc = jcontainer.compress(x)
        out[name] = {
            "blob": cc.to_bytes(),
            "decoded": jcontainer.decompress(cc).tobytes(),
            "sum": jengine.query_sum(cc),
            "count": jengine.query_filter_count(cc, *worker.COUNT_RANGE),
            "groupby": jengine.query_groupby(cc, worker.group_keys(len(x)),
                                             worker.GROUPS),
        }
    return out


def _float_bits(v: float) -> int:
    v = float(v)
    return -1 if math.isnan(v) else int(np.float64(v).view(np.uint64))


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_compress_sharded_equals_jax_compress(ranks, jax_answers, name):
    for r in ranks:
        assert r["blob"][name] == jax_answers[name]["blob"], r["rank"]


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_decompress_sharded_equals_jax_decompress(ranks, jax_answers, name):
    for r in ranks:
        dev, data = r["decoded"][name]
        assert dev == "cpu"
        assert data == jax_answers[name]["decoded"], r["rank"]


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_sharded_decode_equals_jax_decompress(ranks, jax_answers, name):
    for r in ranks:
        assert r["shards"][name] == jax_answers[name]["decoded"], r["rank"]


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_sharded_sum_equals_query_sum_and_fsum(ranks, jax_answers, name):
    fsum = worker.fsum_reference(COLUMNS[name])
    for r in ranks:
        got = r["sum"][name]
        assert _float_bits(got) == _float_bits(jax_answers[name]["sum"])
        assert _float_bits(got) == _float_bits(fsum)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_sharded_count_equals_query_filter_count(ranks, jax_answers, name):
    for r in ranks:
        assert r["count"][name] == jax_answers[name]["count"]


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_sharded_groupby_equals_query_groupby(ranks, jax_answers, name):
    want = jax_answers[name]["groupby"]
    for r in ranks:
        got = r["groupby"][name]
        assert sorted(got) == sorted(want)
        for agg in want:
            assert _same_bits(got[agg], want[agg]), (r["rank"], agg)


def test_sharded_step_equals_jax_step(ranks):
    world = len(ranks)
    values, combos, k_count = worker.step_problem()
    if len(jax.devices()) < world:
        pytest.skip("not enough virtual devices")
    nm = numerics_for(np.float64)
    want = jax_step(jax_mesh(world), np.float64)(
        nm.values_from_np(values), combos, k_count)
    for r in ranks:
        got = r["step"]
        for k in ("fac", "exp", "bit_width", "exc_count"):
            np.testing.assert_array_equal(got[k].astype(np.int64),
                                          np.asarray(want[k]).astype(
                                              np.int64), err_msg=k)
        np.testing.assert_array_equal(got["base"], np.asarray(want["base"]))
        assert bool(got["ok"].all()) == bool(want["ok"])
        assert abs(got["global_bits_per_value"]
                   - float(want["global_bits_per_value"])) <= 1e-5


def test_cross_rank_join_does_not_wrap(ranks):
    width = kes.WINDOWS[torch.int64] + 3
    rows = np.concatenate([worker.join_rows(r, width)
                           for r in range(len(ranks))])
    W = width - 3
    want = sum(int(t) << (32 * w) for row in rows.tolist()
               for w, t in enumerate(row[:W]))
    counts = [int(c) for c in rows[:, W:].sum(0)]
    # the same rows reduced in int64 would wrap: the join must not
    with np.errstate(over="ignore"):
        wrapped = rows[:, :W].sum(0)
    exact = [sum(int(t) for t in rows[:, w]) for w in range(W)]
    assert any(int(a) != b for a, b in zip(wrapped, exact))
    for r in ranks:
        total, nan, pinf, ninf, scale = r["join"]
        assert total == want
        assert [nan, pinf, ninf] == counts
        assert scale == 1075
