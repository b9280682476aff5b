"""The port's CUDA kernels on the card (every test is marked ``cuda``).

Each kernel is held against its plain PyTorch version on the same plan
buckets, bit for bit, and the whole decode against the input.  This file
imports neither JAX nor ``alp_tpu``, so it runs on a machine with a card
and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

import alp_tpu_torch
from alp_tpu_torch import constants as C
from alp_tpu_torch.columns import route_columns
from alp_tpu_torch.kernels import decode, falp

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
