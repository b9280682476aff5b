"""Plan snapshots of the port (``alp_tpu_torch.plan_store``) on the CPU.

* ``restore(snapshot(plan), device="cpu")`` decodes every route column (bit
  widths 0, <= 32, 33-52 and 53-64, f64 and f32 ALP_RD, mixed, NaN / +-Inf
  / -0.0 with a tail, and an empty column) equal by bits to
  ``alp_tpu.container.decompress``, with and without zstd;
* a payload of 64 KiB or more is zstd-compressed when that is smaller, and
  stored raw without libzstd;
* the SUM, COUNT and filter steps on a restored plan (``save_plan`` /
  ``load_plan`` through a file) equal the JAX package's queries (the model:
  ``tests/test_plan_store.py::test_restored_plan_serves_queries``);
* a kept ``key_extent`` and ``vector_sums`` come back;
* garbage, a JAX package blob, a truncated blob and a corrupt zstd payload
  raise ``ValueError``; ``device=None`` raises without a card;
* the port's ``zstd_bits`` / ``zstd_roundtrip`` equal
  ``alp_tpu.competitors.zstd_codec``'s.
"""

import math

import numpy as np
import pytest
import torch

from alp_tpu import container as jcontainer
from alp_tpu import engine as jengine
from alp_tpu import plan_store as jplan_store
from alp_tpu.competitors import zstd_codec as jzstd

import alp_tpu_torch
from alp_tpu_torch import constants as C
from alp_tpu_torch import engine, plan_store
from alp_tpu_torch.columns import route_columns
from alp_tpu_torch.competitors import zstd_codec

CPU = torch.device("cpu")
COLUMNS = dict(route_columns(np.random.default_rng(9),
                             2 * C.N_VECTORS_PER_ROWGROUP),
               empty=np.zeros(0))
QUERY_COLUMNS = ("bench_bw20_food_prices", "f64_mixed_alp_rd", "f32_alp_rd")
RANGE = (-10.0, 60.0)


def _float_bits(v: float) -> int:
    v = float(v)
    return -1 if math.isnan(v) else int(np.float64(v).view(np.uint64))


def _restored(x, compress=True):
    col = alp_tpu_torch.compress(x)
    blob = plan_store.snapshot(col.plan(CPU), compress=compress)
    return col, blob, plan_store.restore(blob, device="cpu")


@pytest.mark.parametrize("compress", [True, False], ids=["zstd", "raw"])
@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_restored_plan_decodes_like_jax(name, compress):
    x = COLUMNS[name]
    col, blob, plan = _restored(x, compress)
    if not compress:
        assert plan_store.snapshot_codec(blob) == "raw"
    assert plan.device == CPU
    assert (plan.n_values, plan.n_vectors) == (col.n_values, col.n_vectors)
    got = plan.run().reshape(-1)[:len(x)].numpy()
    want = jcontainer.decompress(jcontainer.compress(x))
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    # the CSRs that are not stored are rebuilt equal
    built = col.plan(CPU)
    assert torch.equal(plan.exc_ptr, built.exc_ptr)
    assert torch.equal(plan.rd_exc_ptr, built.rd_exc_ptr)


def test_restored_views_are_aligned():
    _, _, plan = _restored(COLUMNS["f64_mixed_alp_rd"])
    tensors = [t for b in plan.buckets for t in (b.rows, *b.args)]
    tensors += [plan.exc_index, plan.exc_bits, plan.rd_exc_index,
                plan.rd_exc_left, plan.rd_exc_rbw]
    base = plan.buckets[0].rows.untyped_storage().data_ptr()
    for t in tensors:
        if t.numel():
            assert (t.data_ptr() - base) % 256 == 0


def _repetitive_column() -> np.ndarray:
    vec = np.round(np.random.default_rng(4).uniform(0, 100, 1024), 2)
    return np.tile(vec, 3 * C.N_VECTORS_PER_ROWGROUP)


def test_large_payload_takes_zstd_when_smaller():
    x = _repetitive_column()
    col, blob, plan = _restored(x)
    raw = plan_store.snapshot(col.plan(CPU), compress=False)
    assert len(raw) >= 1 << 16
    assert plan_store.snapshot_codec(blob) == "zstd"
    assert len(blob) < len(raw)
    assert plan.run().reshape(-1).numpy().tobytes() == x.tobytes()


def test_payload_stays_raw_without_libzstd(monkeypatch):
    monkeypatch.setattr(zstd_codec, "HAVE_ZSTD", False)
    x = _repetitive_column()
    _, blob, plan = _restored(x)
    assert plan_store.snapshot_codec(blob) == "raw"
    assert plan.run().reshape(-1).numpy().tobytes() == x.tobytes()


def test_small_payload_stays_raw():
    _, blob, _ = _restored(np.linspace(0.0, 1.0, 2000))
    assert plan_store.snapshot_codec(blob) == "raw"


@pytest.fixture(scope="module")
def query_answers():
    """The JAX package's SUM and COUNT of the query columns."""
    out = {}
    for name in QUERY_COLUMNS:
        cc = jcontainer.compress(COLUMNS[name])
        out[name] = (jengine.query_sum(cc),
                     jengine.query_filter_count(cc, *RANGE))
    return out


@pytest.mark.parametrize("name", QUERY_COLUMNS)
def test_restored_plan_serves_queries(name, query_answers, tmp_path):
    col = alp_tpu_torch.compress(COLUMNS[name])
    path = tmp_path / "col.alps"
    n = plan_store.save_plan(col, path, device="cpu")
    assert n == path.stat().st_size > 0
    plan = plan_store.load_plan(path, device="cpu")
    want_sum, want_count = query_answers[name]
    zero = torch.zeros((), dtype=torch.int64)
    step, args = engine.make_exact_sum_step(plan)
    got = engine._finish_sum(*step.answer(step.result(zero, *args)))
    assert _float_bits(got) == _float_bits(want_sum)
    assert torch.equal(engine.exact_sum_totals(plan),
                       engine.exact_sum_totals(col.plan(CPU)))
    step, args = engine.make_filter_step(plan, *RANGE)
    assert int(step.result(zero, *args)) == want_count
    klo, khi = (engine._float_key(v, col.dtype) for v in RANGE)
    thr = np.array([klo - 1, khi], engine._key_type(col.dtype))
    bins = engine.key_count_bins(plan, thr)
    assert torch.equal(bins, engine.key_count_bins(col.plan(CPU), thr))
    assert int(bins[1]) == want_count


@pytest.mark.parametrize("name", ["f64_mixed_alp_rd", "f32_alp"])
def test_kept_extent_and_vector_sums_round_trip(name):
    col = alp_tpu_torch.compress(COLUMNS[name])
    built = col.plan(CPU)
    bare = plan_store.restore(plan_store.snapshot(built), device="cpu")
    assert bare.key_extent is None and bare.vector_sums is None
    engine._plan_key_extent(built)
    engine._plan_vector_sums(built)
    plan = plan_store.restore(plan_store.snapshot(built), device="cpu")
    assert plan.key_extent == built.key_extent
    for a, b in zip(plan.vector_sums, built.vector_sums):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a restored plan serves the queries that read them
    col._plans.clear()
    col._plans["cpu"] = plan
    x = COLUMNS[name]
    assert alp_tpu_torch.query_max(col, device="cpu") == x.max()
    keys = np.repeat(np.arange(4), -(-len(x) // 4))[:len(x)]
    got = alp_tpu_torch.query_groupby(col, keys, 4, aggs=("sum",),
                                      device="cpu")["sum"]
    want = [math.fsum(x[keys == g].astype(np.float64).tolist())
            for g in range(4)]
    assert got.tobytes() == np.array(want).astype(x.dtype).tobytes()


def test_rejects_garbage_and_other_formats():
    x = COLUMNS["f64_mixed_alp_rd"]
    with pytest.raises(ValueError):
        plan_store.restore(b"NOPE" + b"\0" * 32, device="cpu")
    with pytest.raises(ValueError):
        plan_store.restore(b"", device="cpu")
    jblob = jplan_store.snapshot(jcontainer.compress(x).plan())
    with pytest.raises(ValueError):
        plan_store.restore(jblob, device="cpu")


@pytest.mark.parametrize("cut", [1, 100, 10_000])
def test_rejects_truncated_blob(cut):
    _, blob, _ = _restored(COLUMNS["f64_mixed_alp_rd"])
    with pytest.raises(ValueError):
        plan_store.restore(blob[:-cut], device="cpu")
    with pytest.raises(ValueError):
        plan_store.restore(blob + b"\0" * cut, device="cpu")


def test_rejects_corrupt_zstd():
    _, blob, _ = _restored(_repetitive_column())
    assert plan_store.snapshot_codec(blob) == "zstd"
    start = len(blob) - plan_store._header(blob)[5]
    bad = bytearray(blob)
    bad[start:start + 4] = b"\0\0\0\0"          # the frame's magic
    with pytest.raises(ValueError, match="zstd"):
        plan_store.restore(bytes(bad), device="cpu")


def test_default_device_raises_without_a_card(monkeypatch):
    _, blob, _ = _restored(COLUMNS["f32_alp"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_store.restore(blob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_store.restore(blob, device="cuda")


def test_package_exports():
    assert alp_tpu_torch.save_plan is plan_store.save_plan
    assert alp_tpu_torch.load_plan is plan_store.load_plan


ZSTD_ARRAYS = {
    "f64_rowgroups_and_tail": np.round(
        np.random.default_rng(1).uniform(0, 100, 2 * 102_400 + 777), 2),
    "f32": np.random.default_rng(2).standard_normal(50_000).astype(
        np.float32),
    "empty": np.zeros(0),
}


@pytest.mark.parametrize("name", sorted(ZSTD_ARRAYS))
def test_zstd_codec_equals_jax_package(name):
    x = ZSTD_ARRAYS[name]
    assert zstd_codec.HAVE_ZSTD == jzstd.HAVE_ZSTD
    assert zstd_codec.zstd_version() == jzstd.zstd_version()
    assert zstd_codec.ROWGROUP_VALUES == jzstd.ROWGROUP_VALUES
    assert zstd_codec.zstd_bits(x) == jzstd.zstd_bits(x)
    assert zstd_codec.zstd_roundtrip(x) == jzstd.zstd_roundtrip(x)
