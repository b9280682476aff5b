"""The port's CUDA kernels on the card (every test is marked ``cuda``).

Each kernel is held against its plain PyTorch version on the same plan
buckets, bit for bit (the SUM kernels' integer totals exactly), the whole
decode against the input, ``query_sum`` against ``math.fsum``, and the
device compress kernels K9-K14 against their plain versions and
``compress_device``'s blob against host compress's, in both precisions,
the key kernels K15/K16/K17 and the filtered SUM against their plain
versions, every predicate and order query on the card against its answer
on the CPU, QUANTILE / MEDIAN on the card against ``np.quantile``, and the
grouped kernels K18/K19 against their plain versions and GROUP-BY, windows
and DISTINCT on the card against their answers on the CPU.  This file
imports neither JAX nor ``alp_tpu``, so it runs on a machine with a card
and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Without a card every test skips.
"""

import math
import struct
from fractions import Fraction

import numpy as np
import pytest
import torch

import alp_tpu_torch
from alp_tpu_torch import constants as C
from alp_tpu_torch import engine
from alp_tpu_torch.columns import route_columns
from alp_tpu_torch.kernels import decode, falp
from alp_tpu_torch.kernels import encode as kenc
from alp_tpu_torch.kernels import exact_sum as kes
from alp_tpu_torch.kernels import ffor as kffor
from alp_tpu_torch.kernels import keys as kkeys
from alp_tpu_torch.kernels import score as kscore
from alp_tpu_torch.ops.keys import bias, biased_keys

pytestmark = pytest.mark.cuda
COLUMNS = route_columns(np.random.default_rng(5),
                        2 * C.N_VECTORS_PER_ROWGROUP)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits_dtype(plan):
    return torch.int64 if plan.f64 else torch.int32


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_kernels_equal_plain_versions(name, cuda):
    plan = decode.build_plan(alp_tpu_torch.compress(COLUMNS[name]), cuda)
    vdt = torch.float64 if plan.f64 else torch.float32
    bits = _bits_dtype(plan)
    for bucket in plan.buckets:
        got = torch.zeros((plan.n_vectors, 1024), dtype=vdt, device=cuda)
        want = torch.zeros_like(got)
        before = sum(falp.LAUNCHES.values())
        plan.launch(bucket, got)
        assert sum(falp.LAUNCHES.values()) == before + 1
        if bucket.scheme == C.SCHEME_ALP:
            want[bucket.rows] = falp.falp_plain(bucket.args[0], bucket.bw,
                                                *bucket.args[1:])
        else:
            right, left, dictionary, dict_size = bucket.args
            want.view(bits)[bucket.rows] = falp.rd_plain(
                right, bucket.bw, left, bucket.lbw, dictionary, dict_size)
        torch.cuda.synchronize()
        assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_decode_on_card_equals_input(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.CompressedColumn.from_bytes(
        alp_tpu_torch.compress(x).to_bytes())
    falp.reset_launches()
    out = alp_tpu_torch.decompress(col)
    assert out.device.type == "cuda"
    assert sum(falp.LAUNCHES.values()) == len(
        decode.build_plan(col, cuda).buckets)
    got = out.cpu().numpy()
    assert np.array_equal(got.view(f"u{got.dtype.itemsize}"),
                          x.view(f"u{x.dtype.itemsize}"))


def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(falp, "falp_plain", refuse)
    monkeypatch.setattr(falp, "rd_plain", refuse)
    monkeypatch.setattr(kenc, "encode_plain", refuse)
    monkeypatch.setattr(kenc, "encode_plain_f32", refuse)
    monkeypatch.setattr(kffor, "ffor_plain", refuse)
    monkeypatch.setattr(kscore, "score_plain", refuse)
    monkeypatch.setattr(kscore, "score_plain_f32", refuse)
    for name in ("key_counts_alp_plain", "key_counts_rd_plain",
                 "key_extremes_alp_plain", "key_extremes_rd_plain",
                 "counts_of_bits", "extremes_of_bits", "rank_pass_alp_plain",
                 "rank_pass_rd_plain", "rank_pass_of_bits"):
        monkeypatch.setattr(kkeys, name, refuse)
    x = COLUMNS["f64_mixed_alp_rd"]
    col = alp_tpu_torch.compress(x)
    alp_tpu_torch.decompress(col)
    kkeys.reset_launches()
    assert alp_tpu_torch.query_filter_count(col, 10.0, 50.0) == int(
        ((x >= 10.0) & (x <= 50.0)).sum())
    assert alp_tpu_torch.query_max(col) == x.max()
    assert alp_tpu_torch.query_median(col) == np.median(x)
    assert all(kkeys.LAUNCHES.values()), kkeys.LAUNCHES
    for reset in (kenc.reset_launches, kffor.reset_launches,
                  kscore.reset_launches):
        reset()
    assert alp_tpu_torch.compress_device(x).to_bytes() == col.to_bytes()
    for name in ("f32_alp", "f32_alp_rd"):
        x32 = COLUMNS[name]
        assert alp_tpu_torch.compress_device(x32).to_bytes() == \
            alp_tpu_torch.compress(x32).to_bytes()
    for launches in (kenc.LAUNCHES, kscore.LAUNCHES):
        assert all(launches.values()), launches
    assert kffor.LAUNCHES["ffor_pack_f64"] and \
        kffor.LAUNCHES["ffor_pack_f32"], kffor.LAUNCHES
    torch.cuda.synchronize()


def test_mixed_devices_raise(cuda):
    n, bw = 2, 3
    with pytest.raises(ValueError):
        falp.falp_decode_f64(
            torch.zeros((n, bw * 16), dtype=torch.int64, device=cuda), bw,
            torch.zeros(n, dtype=torch.int64),
            torch.ones(n, dtype=torch.int64, device=cuda),
            torch.ones(n, dtype=torch.float64, device=cuda))


def _special_sum(x):
    if np.isnan(x).any() or (np.isposinf(x).any() and np.isneginf(x).any()):
        return float("nan")
    if np.isposinf(x).any():
        return float("inf")
    if np.isneginf(x).any():
        return float("-inf")
    return None


def _fsum(x):
    special = _special_sum(x)
    return special if special is not None else math.fsum(
        x.astype(np.float64).tolist())


def _same(a, b):
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return struct.pack("<d", a) == struct.pack("<d", b)


def _sum_cases():
    rng = np.random.default_rng(9)
    adv = np.zeros(2048)
    adv[:7] = [1e300, -1e300, 1.0, 2.0 ** -1000, 1e16, 1.0, -1e16]
    sub_rd = rng.standard_normal(2048)
    sub_rd[[17, 900]] = [5e-324, -3e-310]
    sub_alp = np.round(rng.uniform(-5, 5, 2048), 2)
    sub_alp[[17, 900]] = [5e-324, -3e-310]
    sub32 = rng.standard_normal(2048).astype(np.float32)
    sub32[11] = np.float32(1e-44)
    tail_pi = np.round(rng.uniform(-5, 5, 1500), 2)
    tail_pi[-1] = np.pi
    tail_zero = tail_pi.copy()
    tail_zero[-1] = -0.0
    exc = np.round(rng.uniform(-10, 10, 4096), 2)
    exc[[5, 700, 2049]] = [np.pi, 1e300, -0.0]
    cases = {"adversarial": adv, "subnormal_rd": sub_rd,
             "subnormal_alp": sub_alp, "subnormal_f32": sub32,
             "subnormal_const": np.full(1024, 5e-324),
             "tail_pi": tail_pi, "tail_negzero": tail_zero,
             "exceptions": exc, "one_value": np.array([0.1]),
             "empty": np.zeros(0)}
    for specials in ([np.nan], [np.inf], [-np.inf], [np.inf, -np.inf],
                     [np.nan, np.inf, -np.inf]):
        x = np.round(rng.uniform(-100, 100, 3000), 1)
        x[rng.choice(3000, len(specials), replace=False)] = specials
        cases["specials_" + "_".join(map(str, specials))] = x
    return cases


SUM_CASES = _sum_cases()


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_sum_kernels_equal_plain_versions(name, cuda):
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    for call in engine.sum_calls(plan):
        before = kes.LAUNCHES[call.kernel]
        got = call.launch(kes.totals(plan.bits_dtype, cuda))
        assert kes.LAUNCHES[call.kernel] == before + 1
        assert torch.equal(got, call.plain()), (name, call.kernel, call.bw)


def test_plan_is_kept_once_per_card(cuda):
    col = alp_tpu_torch.compress(COLUMNS["bench_bw20_food_prices"])
    plan = col.plan()
    index = torch.cuda.current_device()
    assert col.plan("cuda") is plan
    assert col.plan(f"cuda:{index}") is plan
    assert col.plan(torch.device("cuda", index)) is plan
    assert list(col._plans) == [f"cuda:{index}"]


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_query_sum_on_card_equals_fsum(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    kes.reset_launches()
    assert _same(alp_tpu_torch.query_sum(col), _fsum(x))
    assert sum(kes.LAUNCHES.values()) > 0
    assert _same(alp_tpu_torch.query_sum(col), _fsum(x))   # cached plan


@pytest.mark.parametrize("name", sorted(SUM_CASES))
def test_query_sum_and_mean_on_card_special_cases(name, cuda):
    x = SUM_CASES[name]
    col = alp_tpu_torch.compress(x)
    assert _same(alp_tpu_torch.query_sum(col), _fsum(x))
    special = _special_sum(x)
    if not len(x):
        want = float("nan")
    elif special is not None:
        want = special
    else:
        want = float(sum(map(Fraction, x.astype(np.float64).tolist()),
                         Fraction(0)) / len(x))
    assert _same(alp_tpu_torch.query_mean(col), want)


def test_sum_kernels_refuse_cpu_out_for_cuda_input(cuda):
    bits = torch.zeros((2, 1024), dtype=torch.int64, device=cuda)
    vec = torch.arange(2, device=cuda)
    with pytest.raises(ValueError):
        kes.exact_sum_f64(bits, vec, 2048,
                          out=torch.zeros(69, dtype=torch.int64))


# ---------------------------------------------------------------------------
# device compress: K9-K11 and compress_device
# ---------------------------------------------------------------------------

F64 = sorted(name for name, x in COLUMNS.items() if x.dtype == np.float64)
F32 = sorted(name for name, x in COLUMNS.items() if x.dtype == np.float32)


def _encode_case(rng, n=64):
    vals = np.round(rng.uniform(-500, 500, (n, 1024)), 2)
    vals[1] = rng.standard_normal(1024) * 1e6
    vals[2, :6] = [np.nan, -np.inf, np.inf, -0.0, 0.0, 1e308]
    vals[3] = np.nan
    vals[4, 10:20] = [5e-324, -1e-310, 2.0**53, -(2.0**55), 2.0**60, 1e18,
                      -1e17, 9.2e18, -9.3e18, 2.0**-1074]
    e = rng.integers(0, 19, n).astype(np.int32)
    f = np.minimum(rng.integers(0, 19, n), e).astype(np.int32)
    return (torch.from_numpy(vals), torch.from_numpy(e),
            torch.from_numpy(f))


@pytest.mark.parametrize("stats", [True, False])
def test_k9_equals_its_plain_version(cuda, stats):
    vals, e, f = _encode_case(np.random.default_rng(1))
    before = kenc.LAUNCHES["alp_encode_f64"]
    got = kenc.alp_encode_f64(vals.to(cuda), e.to(cuda), f.to(cuda),
                              stats=stats)
    assert kenc.LAUNCHES["alp_encode_f64"] == before + 1
    want = kenc.encode_plain(vals, e, f, stats)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("bw", [1, 7, 31, 32, 33, 52, 63, 64])
def test_k10_equals_its_plain_version(cuda, bw):
    rng = np.random.default_rng(bw)
    t = torch.from_numpy
    ints = t(rng.integers(-2**63, 2**63, (40, 1024), dtype=np.int64))
    base = t(rng.integers(-2**63, 2**63, 40, dtype=np.int64))
    exc = t(rng.random((40, 1024)) < 0.05)
    fill = t(rng.integers(-2**40, 2**40, 40, dtype=np.int64))
    rows = t(np.array([3, 39, 0, 17]))
    for kw in ({}, {"exc": exc, "fill": fill}, {"rows": rows}):
        dev = {k: v.to(cuda) for k, v in kw.items()}
        got = kffor.ffor_pack_f64(ints.to(cuda), base.to(cuda), bw, **dev)
        want = kffor.ffor_plain(ints, base, bw, kw.get("exc"),
                                kw.get("fill"), kw.get("rows"))
        assert torch.equal(got.cpu(), want), kw
    out = torch.zeros(4 * 16 * bw + 5, dtype=torch.int64, device=cuda)
    offsets = t(np.array([5, 5 + 48 * bw, 5 + 16 * bw, 5 + 32 * bw]))
    kffor.ffor_pack_f64(ints.to(cuda), base.to(cuda), bw, rows=rows.to(cuda),
                        out=out, offsets=offsets.to(cuda))
    want = kffor.ffor_plain(ints, base, bw, rows=rows)
    for r, o in enumerate(offsets.tolist()):
        assert torch.equal(out[o:o + 16 * bw].cpu(), want[r])


def test_k11_equals_its_plain_version(cuda):
    rng = np.random.default_rng(2)
    x = np.round(rng.uniform(-100, 100, (3, 9, 32)), 2)
    x[0, 0, :6] = [np.nan, np.inf, -np.inf, -0.0, 5e-324, -(2.0**63)]
    x[1, 1] = np.nan
    x[2] = rng.standard_normal((9, 32)) * 1e12
    samples = torch.from_numpy(x)
    got = kscore.first_level_scores_f64(samples.to(cuda))
    want = kscore.first_level_scores_f64(samples)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    strides = samples.reshape(-1, 32)
    n = strides.shape[0]
    e = rng.integers(0, 19, (n, 5))
    combos = torch.from_numpy(np.stack(
        [e, rng.integers(0, 19, (n, 5)) % (e + 1)], -1).astype(np.int32))
    k = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    got = kscore.second_level_scores_f64(strides.to(cuda), combos.to(cuda),
                                         k.to(cuda))
    assert torch.equal(got.cpu(),
                       kscore.second_level_scores_f64(strides, combos, k))


def _encode_case32(rng, n=64):
    vals = np.round(rng.uniform(-500, 500, (n, 1024)), 2).astype(np.float32)
    vals[1] = rng.standard_normal(1024).astype(np.float32) * 1e4
    vals[2, :6] = [np.nan, -np.inf, np.inf, -0.0, 0.0, 3e38]
    vals[3] = np.nan
    vals[4, 10:20] = [1e-44, -1e-40, 1.4e-45, 2.2e7, -2.2e7, 2147483520.0,
                      -2147483648.0, 1e30, -1e30, 21474836.0]
    e = rng.integers(0, 11, n).astype(np.int32)
    f = np.minimum(rng.integers(0, 11, n), e).astype(np.int32)
    e[:2], f[:2] = 10, 10                 # past the FACT table: all exceptions
    return (torch.from_numpy(vals), torch.from_numpy(e),
            torch.from_numpy(f))


@pytest.mark.parametrize("stats", [True, False])
def test_k12_equals_its_plain_version(cuda, stats):
    vals, e, f = _encode_case32(np.random.default_rng(1))
    before = kenc.LAUNCHES["alp_encode_f32"]
    got = kenc.alp_encode_f32(vals.to(cuda), e.to(cuda), f.to(cuda),
                              stats=stats)
    assert kenc.LAUNCHES["alp_encode_f32"] == before + 1
    want = kenc.encode_plain_f32(vals, e, f, stats)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("bw", [1, 7, 15, 16, 17, 31, 32])
def test_k13_equals_its_plain_version(cuda, bw):
    rng = np.random.default_rng(bw)
    t = torch.from_numpy
    ints = t(rng.integers(-2**31, 2**31, (40, 1024)).astype(np.int32))
    base = t(rng.integers(-2**31, 2**31, 40).astype(np.int32))
    exc = t(rng.random((40, 1024)) < 0.05)
    fill = t(rng.integers(-2**20, 2**20, 40).astype(np.int32))
    rows = t(np.array([3, 39, 0, 17]))
    for kw in ({}, {"exc": exc, "fill": fill}, {"rows": rows}):
        dev = {k: v.to(cuda) for k, v in kw.items()}
        before = kffor.LAUNCHES["ffor_pack_f32"]
        got = kffor.ffor_pack_f32(ints.to(cuda), base.to(cuda), bw, **dev)
        assert kffor.LAUNCHES["ffor_pack_f32"] == before + 1
        want = kffor.ffor_plain(ints, base, bw, kw.get("exc"),
                                kw.get("fill"), kw.get("rows"))
        assert torch.equal(got.cpu(), want), kw
    out = torch.zeros(4 * 32 * bw + 5, dtype=torch.int32, device=cuda)
    offsets = t(np.array([5, 5 + 96 * bw, 5 + 32 * bw, 5 + 64 * bw]))
    kffor.ffor_pack_f32(ints.to(cuda), base.to(cuda), bw, rows=rows.to(cuda),
                        out=out, offsets=offsets.to(cuda))
    want = kffor.ffor_plain(ints, base, bw, rows=rows)
    for r, o in enumerate(offsets.tolist()):
        assert torch.equal(out[o:o + 32 * bw].cpu(), want[r])


def test_k14_equals_its_plain_version(cuda):
    rng = np.random.default_rng(2)
    x = np.round(rng.uniform(-100, 100, (3, 9, 32)), 2).astype(np.float32)
    x[0, 0, :8] = [np.nan, np.inf, -np.inf, -0.0, 1e-44, -2147483648.0,
                   3e38, 2.2e7]
    x[0, 1, ::2] = -0.0
    x[1, 1] = np.nan
    x[2] = rng.standard_normal((9, 32)).astype(np.float32) * 1e4
    samples = torch.from_numpy(x)
    before = kscore.LAUNCHES["score_pairs_f32"]
    got = kscore.first_level_scores_f32(samples.to(cuda))
    assert kscore.LAUNCHES["score_pairs_f32"] == before + 1
    want = kscore.first_level_scores_f32(samples)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    strides = samples.reshape(-1, 32)
    n = strides.shape[0]
    e = rng.integers(0, 11, (n, 5))
    combos = torch.from_numpy(np.stack(
        [e, rng.integers(0, 11, (n, 5)) % (e + 1)], -1).astype(np.int32))
    k = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    got = kscore.second_level_scores_f32(strides.to(cuda), combos.to(cuda),
                                         k.to(cuda))
    assert torch.equal(got.cpu(),
                       kscore.second_level_scores_f32(strides, combos, k))


@pytest.mark.parametrize("name", F64 + F32)
def test_compress_device_equals_host_compress(name, cuda):
    x = COLUMNS[name]
    want = alp_tpu_torch.compress(x)
    assert alp_tpu_torch.compress_device(x).to_bytes() == want.to_bytes()
    assert alp_tpu_torch.compress(x, device=True).to_bytes() == \
        want.to_bytes()
    decoded = alp_tpu_torch.decompress(want)
    got = alp_tpu_torch.compress_device(values=decoded,
                                        n_values=want.n_values)
    assert got.to_bytes() == want.to_bytes()


def test_sum_in_runs_on_the_card(cuda):
    x = COLUMNS["f64_mixed_alp_rd"]
    plan = alp_tpu_torch.compress(x).plan(cuda)
    whole = engine.exact_sum_totals(plan)
    runs = engine.exact_sum_totals(plan, run_values=7 * 1024 + 1)
    assert runs.shape[0] > 1
    assert engine.join_totals(runs.tolist(), x.dtype) == \
        engine.join_totals(whole.tolist(), x.dtype)


def test_work_runs_on_the_tensors_card():
    """Decode, SUM, device compress, the queries, the bench's kernels and
    the loop steps, timed by loop_bench from their plan alone, on card 1
    while card 0 is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    x = COLUMNS["f64_mixed_alp_rd"]
    col = alp_tpu_torch.compress(x)
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        out = alp_tpu_torch.decompress(col, other)
        assert out.device == other
        assert np.array_equal(out.cpu().numpy().view(np.uint64),
                              x.view(np.uint64))
        assert _same(alp_tpu_torch.query_sum(col, other), _fsum(x))
        assert alp_tpu_torch.compress_device(x, device=other).to_bytes() \
            == col.to_bytes()
        got = alp_tpu_torch.compress_device(values=out,
                                            n_values=col.n_values)
        assert got.to_bytes() == col.to_bytes()
        x32 = COLUMNS["f32_alp_rd"]
        assert alp_tpu_torch.compress_device(x32, device=other).to_bytes() \
            == alp_tpu_torch.compress(x32).to_bytes()
        assert alp_tpu_torch.query_filter_count(col, 10.0, 50.0, other) \
            == int(((x >= 10.0) & (x <= 50.0)).sum())
        assert alp_tpu_torch.query_min(col, other) == x.min()
        np.testing.assert_array_equal(
            alp_tpu_torch.query_topk(col, 5, device=other),
            np.sort(x)[::-1][:5])
        np.testing.assert_array_equal(
            alp_tpu_torch.query_quantile(col, [0.1, 0.5, 0.9], device=other),
            np.quantile(x, [0.1, 0.5, 0.9]))
        keys = np.arange(len(x)) % 5
        for got, want in (
                (alp_tpu_torch.query_groupby(col, keys, 5, device=other),
                 alp_tpu_torch.query_groupby(col, keys, 5, device="cpu")),
                (alp_tpu_torch.query_window(col, 5000, hop=1000,
                                            device=other),
                 alp_tpu_torch.query_window(col, 5000, hop=1000,
                                            device="cpu"))):
            assert list(got) == list(want)
            for a in got:
                assert _same_array(got[a], want[a]), a
        assert alp_tpu_torch.query_distinct(col, other) == len(np.unique(x))
        # the bench's kernels K20-K23 and a loop step on card 1
        from alp_tpu_torch.kernels import group as kgroup
        from alp_tpu_torch.ops.fastlanes import unffor_unpack
        plan = decode.build_plan(col, other)
        bits = plan.run().view(torch.int64)
        for b in plan.buckets:
            if b.scheme == C.SCHEME_ALP:
                host = [a.cpu() for a in b.args]
                got = falp.variant_sum_f64(b.args[0], b.bw, *b.args[1:])
                assert got.device == other and torch.equal(
                    got.cpu(), falp.variant_sum_plain(host[0], b.bw,
                                                      *host[1:]))
                got = kffor.unffor(b.args[0], b.bw, b.args[1])
                assert got.device == other and torch.equal(
                    got.cpu(), unffor_unpack(host[0], host[1], b.bw))
            else:
                want = bits[b.rows]
                got = falp.rd_glue_f64(b.args[0], b.bw,
                                       _left_parts(want, b.bw))
                assert got.device == other and torch.equal(got, want)
        got = kgroup.key_extremes_bits_f64(bits)
        assert got.device == other and torch.equal(
            got.cpu(), kgroup.key_extremes_bits_plain(bits.cpu()))
        step, args = engine.make_exact_sum_step(plan)
        zero = torch.zeros((), dtype=torch.int64, device=other)
        assert torch.equal(step.result(zero, *args),
                           engine.exact_sum_totals(plan))
        from alp_tpu_torch import benchlib
        for make in (engine.make_exact_sum_step, engine.make_sum_step):
            assert benchlib.loop_bench(*make(plan), 3) > 0
        torch.cuda.synchronize(other)
        assert torch.cuda.current_device() == 0


# ---------------------------------------------------------------------------
# predicate and order queries: K15, K16, the filtered K5-K8
# ---------------------------------------------------------------------------

def _thresholds(plan, n: int, seed: int) -> torch.Tensor:
    """n ascending distinct unsigned keys (held in the bit patterns' signed
    dtype): keys of the column's own values, then random keys."""
    rng = np.random.default_rng(seed)
    ut = np.uint64 if plan.f64 else np.uint32
    own = engine.vector_extremes(plan).cpu().numpy().view(ut).ravel()
    rand = rng.integers(0, np.iinfo(ut).max, 4 * n, dtype=ut,
                        endpoint=True)
    keys = np.unique(np.concatenate([own[:n // 2], rand]))
    keys = np.sort(rng.choice(keys, n, replace=False))
    return torch.from_numpy(keys.view(f"i{keys.itemsize}").copy()).to(
        plan.device)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_key_kernels_equal_plain_versions(name, cuda):
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    for E in (1, 2, 2048, 2049):
        thr = _thresholds(plan, E, E)
        for call in engine.key_calls(plan):
            before = kkeys.LAUNCHES["key_counts"]
            got = call.counts(thr, torch.zeros(E + 1, dtype=torch.int64,
                                               device=cuda))
            assert kkeys.LAUNCHES["key_counts"] == before + -(-E // 2048)
            assert torch.equal(got, call.counts_plain(thr)), (name, E)
    out = torch.zeros((plan.n_vectors, 2), dtype=plan.bits_dtype,
                      device=cuda)
    for call in engine.key_calls(plan):
        before = kkeys.LAUNCHES["key_extremes"]
        call.extremes(out)
        assert kkeys.LAUNCHES["key_extremes"] == before + 1
        assert torch.equal(out[call.rows], call.extremes_plain()), name


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_filtered_sum_kernels_equal_plain_versions(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    plan = col.plan(cuda)
    width = 64 if plan.f64 else 32
    lo, hi = np.quantile(x[np.isfinite(x)], [0.25, 0.75])
    ranges = [(engine._float_key(lo, x.dtype), engine._float_key(hi, x.dtype)),
              (0, (1 << width) - 1)]
    for key_range in ranges:
        for call in engine.sum_calls(plan, key_range):
            got = call.launch(kes.totals(plan.bits_dtype, cuda))
            assert torch.equal(got, call.plain()), (name, call.kernel)
    # the whole key range sums what the unfiltered kernels sum
    assert torch.equal(engine.exact_sum_totals(plan, key_range=ranges[1]),
                       engine.exact_sum_totals(plan))


def _same_array(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_queries_on_card_equal_cpu(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    fin = x[np.isfinite(x)]
    lo, hi = np.quantile(fin, [0.2, 0.6])
    for a, b in ((lo, hi), (-np.inf, np.inf), (-0.0, hi)):
        assert alp_tpu_torch.query_filter_count(col, a, b) == \
            alp_tpu_torch.query_filter_count(col, a, b, device="cpu")
        assert _same(float(alp_tpu_torch.query_filter_sum(col, a, b)),
                     float(alp_tpu_torch.query_filter_sum(col, a, b,
                                                          device="cpu")))
    for q in (alp_tpu_torch.query_min, alp_tpu_torch.query_max):
        assert _same(q(col), q(col, device="cpu"))
    for k in (1, 5, 128, col.n_vectors + 3):
        for largest in (True, False):
            assert _same_array(
                alp_tpu_torch.query_topk(col, k, largest),
                alp_tpu_torch.query_topk(col, k, largest, device="cpu"))
    for edges in (np.linspace(fin.min() - 1, fin.max() + 1, 7),
                  np.linspace(fin.min() - 1, fin.max() + 1, 2500)):
        assert np.array_equal(
            alp_tpu_torch.query_histogram(col, edges),
            alp_tpu_torch.query_histogram(col, edges, device="cpu"))


# ---------------------------------------------------------------------------
# QUANTILE / MEDIAN: K17
# ---------------------------------------------------------------------------

def _brackets(plan, R: int, seed: int) -> torch.Tensor:
    """R brackets of unsigned keys (held in the signed dtype): between the
    column's own keys, one of a single key, one that holds no key of the
    column, the whole key space."""
    rng = np.random.default_rng(seed)
    ut = np.uint64 if plan.f64 else np.uint32
    own = np.unique(engine.vector_extremes(plan).cpu().numpy().view(ut))
    pairs = [(0, np.iinfo(ut).max), (own[0], own[0])]
    if own[0] > 0:
        pairs.append((own[0] - 1, own[0] - 1))
    while len(pairs) < R:
        a, b = np.sort(rng.choice(own, 2))
        pairs.append((a, b))
    br = np.array(pairs[:R], ut)
    return torch.from_numpy(br.view(f"i{br.itemsize}").copy()).to(
        plan.device)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_k17_equals_its_plain_version(name, cuda):
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    for T in (2, 2048):
        thr = _thresholds(plan, T, T)
        for R in (1, 4, 8):
            br = _brackets(plan, R, R)
            for call in engine.key_calls(plan):
                before = kkeys.LAUNCHES["rank_pass"]
                bins, mm = call.rank_pass(thr, br, *kkeys.rank_outputs(
                    T, R, plan.bits_dtype, cuda))
                assert kkeys.LAUNCHES["rank_pass"] == before + 1
                want_bins, want_mm = call.rank_pass_plain(thr, br)
                assert torch.equal(bins, want_bins), (name, T, R)
                assert torch.equal(mm, want_mm), (name, T, R)


def _as_words(plan, keys) -> torch.Tensor:
    """Unsigned numpy keys as the signed words the kernels take."""
    keys = np.ascontiguousarray(keys, np.uint64 if plan.f64 else np.uint32)
    return torch.from_numpy(keys.view(f"i{keys.itemsize}").copy()).to(
        plan.device)


def _all_keys(name: str, plan) -> np.ndarray:
    """The column's distinct unsigned total-order keys, ascending."""
    x = COLUMNS[name]
    bits = torch.from_numpy(x.view(f"i{x.itemsize}").copy())
    keys = bias(biased_keys(bits)).numpy()
    return np.unique(keys.view(np.uint64 if plan.f64 else np.uint32))


def _k17_cases(name: str, plan):
    """(label, unsigned thresholds, [R, 2] unsigned brackets) of K17's
    edges: trees partly full (T in 1, 2, 31, 32, 33, 2047, 2048); brackets
    that overlap, hold no key (between two keys, reversed) or one key; T
    thresholds clustered in R narrow bands, each band a bracket, as the
    bisection places its probes after its first pass."""
    rng = np.random.default_rng(17)
    ut = np.uint64 if plan.f64 else np.uint32
    top = np.iinfo(ut).max
    keys = _all_keys(name, plan)
    own = np.unique(engine.vector_extremes(plan).cpu().numpy().view(ut))
    a, b, c, d = np.sort(rng.choice(keys, 4))
    gaps = np.nonzero(np.diff(keys) > 1)[0]
    empty = ((keys[gaps[0]] + 1, keys[gaps[0] + 1] - 1) if len(gaps)
             else (keys[0] - 1, keys[0] - 1) if keys[0] > 0
             else (keys[-1] + 1, top))
    brackets = np.array([(a, c), (b, d), empty, (own[0], own[0]),
                         (d, a), (0, top), (a, c), (keys[-1], keys[-1])], ut)
    cases = []
    for T in (1, 2, 31, 32, 33, 2047, 2048):
        thr = np.unique(np.concatenate([
            rng.choice(keys, min(T, len(keys)) // 2),
            rng.integers(0, top, T, dtype=ut, endpoint=True)]))
        thr = np.sort(rng.choice(thr, min(T, len(thr)), replace=False))
        cases.append((f"T={T}", thr, brackets[:1 + T % 8]))
    R = 8
    at = np.sort(rng.choice(len(keys), R))
    bands = np.stack([keys[at], keys[np.minimum(at + 3, len(keys) - 1)]], 1)
    m = 2046 // R
    probes = np.unique(np.array(
        [int(lo) + (int(hi) - int(lo)) * j // m for lo, hi in bands
         for j in range(m)] + [int(k) for k in bands.ravel()], ut))
    cases.append(("bands", probes[:2048], bands))
    return cases


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_k17_edges_equal_its_plain_version(name, cuda):
    """K17 on its edges (``_k17_cases``) on every bucket, bit for bit: the
    bw-0 column puts every value in one bin (the uniform-warp path), the
    specials column holds NaN of both signs, +-Inf, -0.0 and a partial
    last vector."""
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    for label, thr, br in _k17_cases(name, plan):
        thr_t, br_t = _as_words(plan, thr), _as_words(plan, br)
        for call in engine.key_calls(plan):
            bins, mm = call.rank_pass(thr_t, br_t, *kkeys.rank_outputs(
                len(thr), len(br), plan.bits_dtype, cuda))
            want_bins, want_mm = call.rank_pass_plain(thr_t, br_t)
            assert torch.equal(bins, want_bins), (name, label)
            assert torch.equal(mm, want_mm), (name, label)


def _quantile_equal(got, want, dtype) -> bool:
    """Bits, a NaN by isnan, a zero by == (numpy returns either sign)."""
    got, want = np.asarray(got), np.asarray(want).astype(dtype)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    nan = np.isnan(want)
    zero = want == 0
    rest = ~nan & ~zero
    return (np.array_equal(np.isnan(got), nan)
            and bool(np.all(got[zero] == 0))
            and np.array_equal(got[rest].view(f"u{got.itemsize}"),
                               want[rest].view(f"u{want.itemsize}")))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_quantile_on_card_equals_numpy(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    qs = np.array((0, 1e-6, 0.001, 0.1, 0.25, 0.5, 0.75, 0.9, 0.999, 1))
    for method in ("linear", "lower", "higher", "midpoint", "nearest"):
        kkeys.reset_launches()
        got = alp_tpu_torch.query_quantile(col, qs, method)
        assert kkeys.LAUNCHES["rank_pass"] >= engine.LAST_RANK_PASSES >= 1
        assert _quantile_equal(got, np.quantile(x, qs, method=method),
                               x.dtype), method
    median = alp_tpu_torch.query_median(col)
    assert type(median) is x.dtype.type
    assert _quantile_equal(median, np.median(x), x.dtype)


# ---------------------------------------------------------------------------
# GROUP-BY, windows, DISTINCT: K18, K19
# ---------------------------------------------------------------------------

def _column_keys(plan, G: int, ordered: bool, seed: int) -> torch.Tensor:
    """int32 [n_vectors, 1024] group ids in column order (the pad -1)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, G, plan.n_values)
    if ordered:
        keys = np.sort(keys)
    kv = np.full(plan.n_vectors * 1024, -1, np.int32)
    kv[:plan.n_values] = keys
    return torch.from_numpy(kv.reshape(-1, 1024)).to(plan.device)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_group_kernels_equal_plain_versions(name, cuda):
    """K18 on every bucket, K19 on every bucket at G in {1, 16, 300, 65536}
    (shared-memory and device-memory accumulators) with random and sorted
    keys."""
    from alp_tpu_torch.kernels import group as kgroup
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    W = kes.WINDOWS[plan.bits_dtype]
    sums = torch.zeros((plan.n_vectors, W + 3), dtype=torch.int64,
                       device=cuda)
    keys = torch.zeros((plan.n_vectors, 2), dtype=plan.bits_dtype,
                       device=cuda)
    for call in engine.group_calls(plan):
        before = kgroup.LAUNCHES["vector_sum_extremes"]
        call.vector_sums(sums, keys)
        assert kgroup.LAUNCHES["vector_sum_extremes"] == before + 1
        want_sums, want_keys = call.vector_sums_plain()
        assert torch.equal(sums[call.rows], want_sums), name
        assert torch.equal(keys[call.rows], want_keys), name
    for G in (1, 16, 300, 65536):
        for ordered in (False, True):
            kv = _column_keys(plan, G, ordered, G)
            for call in engine.group_calls(plan):
                gk = kv[call.rows].contiguous()
                before = kgroup.LAUNCHES["group_reduce"]
                out, ext = call.group_reduce(gk, G, *kgroup.group_outputs(
                    G, plan.bits_dtype, cuda))
                assert kgroup.LAUNCHES["group_reduce"] == before + 1
                want_out, want_ext = call.group_reduce_plain(gk, G)
                assert torch.equal(out, want_out), (name, G, ordered)
                assert torch.equal(ext, want_ext), (name, G, ordered)


# csrc/group.cu kSharedAcc: K19 keeps G groups in shared memory while
# G * ((2 W + 1) * 4 + 16 + 2 * key bytes) fits (SharedGroups::group_bytes:
# f64 363 groups, f32 2048)
SHARED_ACC_BYTES = 200 * 1024


def _shared_groups(plan) -> int:
    W = kes.WINDOWS[plan.bits_dtype]
    return SHARED_ACC_BYTES // ((2 * W + 1) * 4 + 16 + 2 * (8 if plan.f64
                                                             else 4))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_k19_edges_equal_its_plain_version(name, cuda):
    """K19 on every bucket, bit for bit: G on both sides of the shared /
    device boundary (random ids), every key equal, keys distinct within a
    vector (and across the column), ids at G and above (counted nowhere);
    the columns hold NaN of both signs, +-Inf, -0.0 and a partial last
    vector."""
    from alp_tpu_torch.kernels import group as kgroup
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    rng = np.random.default_rng(19)
    n = plan.n_vectors * 1024
    edge = _shared_groups(plan)
    cases = [(G, rng.integers(0, G, n)) for G in (edge, edge + 1)]
    cases += [(16, np.full(n, 5)), (1, np.zeros(n, np.int64)),
              (1024, np.arange(n) % 1024), (n, np.arange(n)),
              (16, rng.integers(0, 40, n)), (edge + 1, rng.integers(
                  edge - 2, 2 * edge, n))]
    for G, ids in cases:
        kv = torch.from_numpy(ids.astype(np.int32).reshape(-1, 1024)).to(
            cuda)
        for call in engine.group_calls(plan):
            gk = kv[call.rows].contiguous()
            out, ext = call.group_reduce(gk, G, *kgroup.group_outputs(
                G, plan.bits_dtype, cuda))
            want_out, want_ext = call.group_reduce_plain(gk, G)
            assert torch.equal(out, want_out), (name, G)
            assert torch.equal(ext, want_ext), (name, G)


def test_group_in_runs_on_the_card(cuda):
    """A group whose values span several runs of K19 is summed exactly:
    the runs add up to the one-run totals."""
    x = COLUMNS["f64_mixed_alp_rd"]
    plan = alp_tpu_torch.compress(x).plan(cuda)
    kv = _column_keys(plan, 3, False, 3)
    outs, ext = engine.group_reduce(plan, kv, 3)
    runs, ext2 = engine.group_reduce(plan, kv, 3, run_values=7 * 1024 + 1)
    assert len(outs) == 1 and len(runs) > 1
    assert torch.equal(sum(runs), outs[0]) and torch.equal(ext2, ext)


def _same_groups(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        _same_array(np.asarray(a[k]), np.asarray(b[k])) for k in a)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_group_queries_on_card_equal_cpu(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    rng = np.random.default_rng(16)
    for G, keys in ((16, rng.integers(0, 16, len(x))),
                    (1000, np.sort(rng.integers(0, 1000, len(x))))):
        assert _same_groups(
            alp_tpu_torch.query_groupby(col, keys, G),
            alp_tpu_torch.query_groupby(col, keys, G, device="cpu"))
    for window, hop in ((100000, None), (102400, None), (4096, 1024)):
        assert _same_groups(
            alp_tpu_torch.query_window(col, window, hop=hop),
            alp_tpu_torch.query_window(col, window, hop=hop, device="cpu"))
    assert alp_tpu_torch.query_distinct(col) == \
        alp_tpu_torch.query_distinct(col, device="cpu")


def test_group_queries_never_take_the_plain_versions(cuda, monkeypatch):
    from alp_tpu_torch.kernels import group as kgroup

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")
    for name in ("sums_of_bits", "groups_of_bits", "vector_sums_alp_plain",
                 "vector_sums_rd_plain", "group_reduce_alp_plain",
                 "group_reduce_rd_plain"):
        monkeypatch.setattr(kgroup, name, refuse)
    monkeypatch.setattr(kgroup, "_PLAIN", {
        k: (v[0], refuse, refuse) for k, v in kgroup._PLAIN.items()})
    x = COLUMNS["f64_mixed_alp_rd"]
    col = alp_tpu_torch.compress(x)
    kgroup.reset_launches()
    keys = np.arange(len(x)) % 7
    got = alp_tpu_torch.query_groupby(col, keys, 7)
    assert got["count"].tolist() == np.bincount(keys).tolist()
    got = alp_tpu_torch.query_window(col, 100000)
    assert _same(float(got["sum"][0]), _fsum(x[:100000]))
    assert kgroup.LAUNCHES["vector_sum_extremes"] and \
        kgroup.LAUNCHES["group_reduce"], kgroup.LAUNCHES


# ---------------------------------------------------------------------------
# The bench's kernels K20-K23 and the loop steps
# ---------------------------------------------------------------------------

def _left_parts(bits: torch.Tensor, rbw: int) -> torch.Tensor:
    """The left part above the low ``rbw`` bits of each pattern, int32."""
    S = 8 * bits.element_size()
    u = bits.to(torch.int64) & ((1 << S) - 1 if S < 64 else -1)
    left = (u >> rbw) & ((1 << (S - rbw)) - 1) if rbw else u
    return left.to(torch.int32) if S == 64 else \
        torch.where(left >= 1 << 31, left - (1 << 32), left).to(torch.int32)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_bench_kernels_equal_plain_versions(name, cuda):
    """K20 and K22 on every ALP bucket, K21 on every ALP_RD bucket (its
    left parts from the full decode, so it gives the decode back) and K23
    on the decoded bits of every f64 column, against their plain versions
    by bits."""
    from alp_tpu_torch.kernels import group as kgroup
    from alp_tpu_torch.ops.fastlanes import unffor_unpack
    plan = decode.build_plan(alp_tpu_torch.compress(COLUMNS[name]), cuda)
    bits = plan.run().view(_bits_dtype(plan))
    for b in plan.buckets:
        if b.scheme == C.SCHEME_ALP:
            before = kffor.LAUNCHES["unffor"]
            got = kffor.unffor(b.args[0], b.bw, b.args[1])
            assert kffor.LAUNCHES["unffor"] == before + 1
            assert torch.equal(got, unffor_unpack(b.args[0], b.args[1], b.bw))
            if plan.f64:
                before = falp.LAUNCHES["variant_sum_f64"]
                got = falp.variant_sum_f64(b.args[0], b.bw, *b.args[1:])
                assert falp.LAUNCHES["variant_sum_f64"] == before + 1
                want = falp.variant_sum_plain(b.args[0], b.bw, *b.args[1:])
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
            continue
        fn = falp.rd_glue_f64 if plan.f64 else falp.rd_glue_f32
        want = bits[b.rows]
        left = _left_parts(want, b.bw)
        got = fn(b.args[0], b.bw, left)
        assert torch.equal(got, want)
        assert torch.equal(got, falp.rd_glue_plain(b.args[0], b.bw, left))
    if plan.f64:
        before = kgroup.LAUNCHES["key_extremes_bits"]
        got = kgroup.key_extremes_bits_f64(bits)
        assert kgroup.LAUNCHES["key_extremes_bits"] == before + 1
        assert torch.equal(got, kgroup.key_extremes_bits_plain(bits))
    torch.cuda.synchronize()


@pytest.mark.parametrize("S,rbw", [(64, 48), (64, 52), (64, 64), (32, 0),
                                   (32, 24), (32, 32)])
def test_k21_on_random_bits(cuda, S, rbw):
    g = torch.Generator(device=cuda).manual_seed(S + rbw)
    dt = torch.int64 if S == 64 else torch.int32
    info = torch.iinfo(dt)
    right = torch.empty((37, rbw * 1024 // S), dtype=dt, device=cuda).random_(
        info.min, info.max, generator=g)
    left = torch.empty((37, 1024), dtype=torch.int32, device=cuda).random_(
        -2**31, 2**31 - 1, generator=g)
    fn = falp.rd_glue_f64 if S == 64 else falp.rd_glue_f32
    assert torch.equal(fn(right, rbw, left),
                       falp.rd_glue_plain(right, rbw, left))


@pytest.mark.parametrize("name", ["bench_bw30_bitcoin", "f32_alp",
                                  "f64_mixed_alp_rd", "f64_specials_tail"])
def test_loop_steps_on_card_equal_queries(name, cuda):
    """Each step at carry 0 on the card against the port's query answers
    on the card; K20 runs in the sum step of an f64 ALP column; every step
    takes a carry and loop_bench times it."""
    from alp_tpu_torch import benchlib
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    plan = col.plan(cuda)
    zero = torch.zeros((), dtype=torch.int64, device=cuda)
    before = falp.LAUNCHES["variant_sum_f64"]
    step, args = engine.make_sum_step(plan)
    parts = step.result(zero, *args)
    if plan.f64 and any(b.scheme == C.SCHEME_ALP and b.bw
                        for b in plan.buckets):
        assert falp.LAUNCHES["variant_sum_f64"] > before
    for b, part in zip(plan.buckets, parts):
        if plan.f64 and b.scheme == C.SCHEME_ALP and b.bw:
            want = falp.variant_sum_plain(b.args[0], b.bw, *b.args[1:])
            assert torch.equal(part.view(torch.int32), want.view(torch.int32))
    step, args = engine.make_exact_sum_step(plan)
    assert torch.equal(step.result(zero, *args),
                       engine.exact_sum_totals(plan))
    fin = np.sort(x[np.isfinite(x)])
    lo, hi = float(fin[len(fin) // 4]), float(fin[3 * len(fin) // 4])
    step, args = engine.make_filter_step(plan, lo, hi)
    assert step.answer(step.result(zero, *args)) == \
        alp_tpu_torch.query_filter_count(col, lo, hi)
    edges = np.linspace(fin[0], fin[-1], 17).tolist()
    step, args = engine.make_histogram_step(plan, edges)
    assert np.array_equal(step.answer(step.result(zero, *args)),
                          alp_tpu_torch.query_histogram(col, edges))
    t, bins = engine.make_topk_step(plan, 5)[0].result(zero, plan)
    assert t.device == bins.device == plan.device
    keys = np.sort(np.random.default_rng(9).integers(0, 7, len(x)))
    for k in (keys, np.random.default_rng(9).integers(0, 7, len(x))):
        step, args = engine.make_groupby_step(col, k, 7, plan=plan)
        got = step.answer(step.result(zero, *args))
        want = engine.group_totals(col, k, 7)
        assert got.totals == want.totals and np.array_equal(got.ct, want.ct)
        assert np.array_equal(got.kmn, want.kmn) and \
            np.array_equal(got.kmx, want.kmx)
    for make in (engine.make_sum_step, engine.make_exact_sum_step):
        assert benchlib.loop_bench(*make(plan), 3) > 0
    torch.cuda.synchronize()
