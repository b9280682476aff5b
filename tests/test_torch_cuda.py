"""The port's CUDA kernels on the card (every test is marked ``cuda``).

Each kernel is held against its plain PyTorch version on the same plan
buckets, bit for bit (the SUM kernels' integer totals exactly), the whole
decode against the input, and ``query_sum`` against ``math.fsum``.  This file
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
from alp_tpu_torch.kernels import exact_sum as kes

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
    def refuse(*args):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(falp, "falp_plain", refuse)
    monkeypatch.setattr(falp, "rd_plain", refuse)
    col = alp_tpu_torch.compress(COLUMNS["f64_mixed_alp_rd"])
    alp_tpu_torch.decompress(col)
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
