"""The exact-SUM kernels' plain versions and the cached plan.

On the CPU each wrapper runs its plain PyTorch version.  Tolerance: none,
the totals are integers.

* K5/K6 ``exact_sum_f64/_f32``: their windows, joined, equal the join of
  ``alp_tpu.engine._exact_partials_f64/_f32`` (the JAX package's digit
  partials) on the same bit patterns, NaN/Inf counts included, and they
  skip the pad positions of a row by its vector id.
* K7/K8 ``falp_decode_f64/_f32_exact_sum``: the fused decode + sum with
  the exceptions written in from the plan's CSR equals K5/K6 over the
  plan's full decode (K1/K2 then the exception scatter).
* ``CompressedColumn.plan``: built once per device, never serialised,
  compared, or carried by ``dataclasses.replace`` or ``tile_column``.

``tests/test_torch_cuda.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alp_tpu import engine as jengine

import alp_tpu_torch
from alp_tpu_torch import constants as C
from alp_tpu_torch import engine
from alp_tpu_torch.columns import route_columns, tile_column
from alp_tpu_torch.kernels import decode
from alp_tpu_torch.kernels import exact_sum as kes

COLUMNS = route_columns(np.random.default_rng(31),
                        2 * C.N_VECTORS_PER_ROWGROUP)
SPECIAL_BITS = {
    np.float64: [0x7FF8000000000000, 0x7FF0000000000000, 0xFFF0000000000000,
                 0x7FF0000000000001, 0x0000000000000001, 0x800FFFFFFFFFFFFF,
                 0x8000000000000000, 0x7FEFFFFFFFFFFFFF, 0xFFEFFFFFFFFFFFFF],
    np.float32: [0x7FC00000, 0x7F800000, 0xFF800000, 0x7F800001, 0x00000001,
                 0x807FFFFF, 0x80000000, 0x7F7FFFFF, 0xFF7FFFFF],
}


def _random_bits(rng, dtype, n_vectors: int) -> np.ndarray:
    """Patterns of every kind: random bits (all exponents), specials,
    subnormals, zeros and the largest finite values."""
    ut = np.uint64 if dtype == np.float64 else np.uint32
    bits = rng.integers(0, np.iinfo(ut).max, n_vectors * 1024,
                        dtype=ut, endpoint=True)
    idx = rng.choice(bits.size, 9 * 20, replace=False)
    bits[idx] = np.tile(np.array(SPECIAL_BITS[dtype], ut), 20)
    return bits


def _jax_join(bits: np.ndarray):
    partials = (jengine._exact_partials_f64 if bits.dtype == np.uint64
                else jengine._exact_partials_f32)
    sums, sp = partials(jnp.asarray(bits))
    sums, sp = np.asarray(sums), np.asarray(sp)
    total = sum(int(sums[j, k]) << (32 * (j + k))
                for j in range(sums.shape[0]) for k in range(sums.shape[1]))
    return total, int(sp[0]), int(sp[1]), int(sp[2])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("cut", [0, 1, 1023, 2500])
def test_k5_k6_equal_jax_partials(dtype, cut):
    rng = np.random.default_rng(cut + (dtype == np.float32))
    n_vec = 3
    bits = _random_bits(rng, dtype, n_vec)
    n_values = n_vec * 1024 - cut
    fn = kes.exact_sum_f64 if dtype == np.float64 else kes.exact_sum_f32
    # rows in another order than their vectors: the mask follows vec
    order = np.array([2, 0, 1])
    rows = torch.from_numpy(
        bits.reshape(n_vec, 1024)[order].view(f"i{bits.itemsize}").copy())
    out = fn(rows, torch.from_numpy(order), n_values)
    got = engine.join_totals(out.tolist(), dtype)[:4]
    assert got == _jax_join(bits[:n_values])
    assert got == engine.host_sum_raw(bits[:n_values].view(dtype))[:4]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_host_mirror_equals_jax(dtype):
    bits = _random_bits(np.random.default_rng(7), dtype, 1)
    ours = engine._f64_fixed if dtype == np.float64 else engine._f32_fixed
    ref = jengine._f64_fixed if dtype == np.float64 else jengine._f32_fixed
    for b in bits[:300].tolist() + SPECIAL_BITS[dtype]:
        assert ours(b) == ref(b), hex(b)


def test_out_accumulates():
    bits = torch.from_numpy(_random_bits(np.random.default_rng(3),
                                         np.float64, 2).view(np.int64))
    rows = bits.reshape(2, 1024)
    vec = torch.arange(2)
    one = kes.exact_sum_f64(rows, vec, 2048)
    two = kes.exact_sum_f64(rows, vec, 2048, out=one.clone())
    assert torch.equal(two, 2 * one)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_fused_k7_k8_equal_k5_k6_over_the_decode(name):
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = decode.build_plan(col, "cpu")
    decoded = plan.run().view(plan.bits_dtype)
    fused = (kes.falp_decode_f64_exact_sum if plan.f64
             else kes.falp_decode_f32_exact_sum)
    summed = kes.exact_sum_f64 if plan.f64 else kes.exact_sum_f32
    alp = [b for b in plan.buckets if b.scheme == C.SCHEME_ALP]
    for b in alp:
        got = fused(b.args[0], b.bw, *b.args[1:], b.rows, plan.exc_ptr,
                    plan.exc_index, plan.exc_bits, plan.n_values)
        want = summed(decoded[b.rows].contiguous(), b.rows, plan.n_values)
        assert torch.equal(got, want), (name, b.bw)
    # and the whole column: the SUM path equals K5/K6 over the decode
    want = summed(decoded, torch.arange(col.n_vectors), col.n_values)
    assert torch.equal(engine.exact_sum_totals(plan), want[None]), name


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_sum_calls_cover_every_vector_once(name):
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = decode.build_plan(col, "cpu")
    calls = engine.sum_calls(plan)
    width = "f64" if plan.f64 else "f32"
    assert {c.kernel for c in calls} <= {f"falp_decode_{width}_exact_sum",
                                         f"exact_sum_{width}"}
    rows = torch.cat([c.rows for c in calls]).sort().values
    assert torch.equal(rows, torch.arange(col.n_vectors))
    out = kes.totals(plan.bits_dtype, "cpu")
    for c in calls:
        c.launch(out)
    assert torch.equal(out, sum(c.plain() for c in calls))
    assert torch.equal(out[None], engine.exact_sum_totals(plan))


def test_plan_csr_and_rd_scratch():
    col = alp_tpu_torch.compress(COLUMNS["f64_mixed_alp_rd"])
    plan = decode.build_plan(col, "cpu")
    assert plan.n_values == col.n_values
    assert plan.exc_ptr.shape == (col.n_vectors + 1,)
    counts = plan.exc_ptr.diff()
    vec = torch.repeat_interleave(torch.arange(col.n_vectors), counts)
    assert torch.equal(vec, plan.exc_index // 1024)
    scratch, vec = plan.decode_rd()
    rd = [b for b in plan.buckets if b.scheme == C.SCHEME_ALP_RD]
    assert torch.equal(vec, torch.cat([b.rows for b in rd]))
    assert torch.equal(scratch, plan.run().view(torch.int64)[vec])


def test_plan_is_cached_and_not_carried():
    x = COLUMNS["bench_bw20_food_prices"]
    col = alp_tpu_torch.compress(x)
    blob = col.to_bytes()
    text = repr(col)
    plan = col.plan("cpu")
    assert col.plan("cpu") is plan
    assert col.plan(torch.device("cpu")) is plan
    assert col.to_bytes() == blob and repr(col) == text
    assert "_plans" not in text
    other = dataclasses.replace(col)
    assert other._plans == {} and other.plan("cpu") is not plan
    tiled = tile_column(col, 250)
    assert tiled._plans == {} and tiled.plan("cpu").n_vectors == 250
    assert "_plans" not in [f.name for f in dataclasses.fields(col)
                            if f.init or f.compare]
    # decompress builds a fresh plan and leaves the cache alone
    out = alp_tpu_torch.decompress(col, device="cpu")
    assert np.array_equal(out.numpy().view(np.uint64), x.view(np.uint64))
    assert list(col._plans) == ["cpu"]


def test_wrappers_check_their_arguments():
    rows = torch.zeros((2, 1024), dtype=torch.int64)
    vec = torch.arange(2)
    with pytest.raises(TypeError):
        kes.exact_sum_f32(rows, vec, 10)
    with pytest.raises(ValueError):
        kes.exact_sum_f64(rows[:, :512], vec, 10)
    with pytest.raises(ValueError):
        kes.exact_sum_f64(rows, vec, -1)
    with pytest.raises(ValueError):
        kes.exact_sum_f64(rows, vec, 10, out=torch.zeros(12,
                                                         dtype=torch.int64))
    with pytest.raises(TypeError):
        kes.exact_sum_f64(rows, vec.to(torch.int32), 10)


def _run_cases() -> dict:
    rng = np.random.default_rng(41)
    cases = dict(COLUMNS)
    special = np.round(rng.uniform(-9, 9, 5000), 2)
    special[[3, 1100, 2500, 4999]] = [np.nan, np.inf, -np.inf, -0.0]
    cases["specials_tail"] = special
    cases["subnormals"] = np.where(rng.random(4096) < 0.5, 5e-324,
                                   rng.standard_normal(4096) * 1e300)
    cases["one_value"] = np.array([0.1])
    return cases


RUN_CASES = _run_cases()


@pytest.mark.parametrize("run_values", [1025, 3 * 1024 + 1])
@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_sum_in_runs_equals_one_total(name, run_values):
    """A column summed in runs of fewer than ``run_values`` values, each
    into its own int64 total, joins to the single total bit for bit (a
    column of 2^31 values or more is summed so)."""
    x = RUN_CASES[name]
    col = alp_tpu_torch.compress(x)
    plan = col.plan("cpu")
    whole = engine.exact_sum_totals(plan)
    runs = engine.exact_sum_totals(plan, run_values=run_values)
    max_rows = (run_values - 1) // 1024
    assert whole.shape[0] == 1
    assert runs.shape[0] >= -(-col.n_vectors // max_rows)
    assert torch.equal(runs.sum(dim=0), whole[0])
    joined = engine.join_totals(runs.tolist(), x.dtype)
    assert joined == engine.join_totals(whole.tolist(), x.dtype)
    assert joined == engine.join_totals(whole[0].tolist(), x.dtype)


def test_sum_call_split_keeps_rows_and_totals():
    col = alp_tpu_torch.compress(COLUMNS["f64_mixed_alp_rd"])
    plan = col.plan("cpu")
    for call in engine.sum_calls(plan):
        parts = call.split(7)
        assert all(p.rows.shape[0] <= 7 for p in parts)
        assert torch.equal(torch.cat([p.rows for p in parts]), call.rows)
        assert torch.equal(sum(p.plain() for p in parts), call.plain())
