"""The port's FastLanes FFOR pack/unpack vs ``alp_tpu.ops.fastlanes``.

Random values and per-vector bases, made with numpy from a seed, are packed
and unpacked by both at every bit width: 0..64 over u64 words, 0..32 over
u32 and 0..16 over u16 (the ALP_RD index words).  Words and values must be
equal bit for bit.
"""

import numpy as np
import pytest
import torch

from alp_tpu.ops import fastlanes as jfl

from alp_tpu_torch.ops import fastlanes as fl

N = 3


def _case(bits, bw, seed):
    rng = np.random.default_rng(seed)
    ut = np.dtype(f"uint{bits}")
    hi = np.iinfo(ut).max
    base = rng.integers(0, hi, N, dtype=ut, endpoint=True)
    delta = rng.integers(0, hi, (N, 1024), dtype=ut, endpoint=True)
    if bw < bits:
        delta &= ut.type((1 << bw) - 1)
    with np.errstate(over="ignore"):
        values = delta + base[:, None]
    return values, base


def _t(a):
    return torch.from_numpy(np.array(a).view(f"i{a.dtype.itemsize}"))


def _np(t, ut):
    return t.numpy().view(ut)


def _check(bits, bw):
    ut = np.dtype(f"uint{bits}")
    values, base = _case(bits, bw, 1000 * bits + bw)
    ref_words = np.asarray(jfl.ffor_pack(values, base, bw=bw), ut)
    words = fl.ffor_pack(_t(values), _t(base), bw)
    assert words.dtype == fl._WORD[bits]
    assert np.array_equal(_np(words, ut), ref_words)
    ref_values = np.asarray(jfl.unffor_unpack(
        ref_words, base, bw=bw, signed=False), ut)
    assert np.array_equal(ref_values, values)
    assert np.array_equal(_np(fl.unffor_unpack(_t(ref_words), _t(base), bw),
                              ut), values)


@pytest.mark.parametrize("bw", range(65))
def test_u64_words_equal_jax(bw):
    _check(64, bw)


@pytest.mark.parametrize("bw", range(33))
def test_u32_words_equal_jax(bw):
    _check(32, bw)


@pytest.mark.parametrize("bw", [0, 1, 2, 3, 7, 15, 16])
def test_u16_words_equal_jax(bw):
    _check(16, bw)


def test_rejects_bad_widths_and_dtypes():
    with pytest.raises(ValueError):
        fl.ffor_pack(torch.zeros(1, 1024, dtype=torch.int32),
                     torch.zeros(1, dtype=torch.int32), 33)
    with pytest.raises(ValueError):
        fl.unffor_unpack(torch.zeros(1, 5, dtype=torch.int64),
                         torch.zeros(1, dtype=torch.int64), 1)
    with pytest.raises(TypeError):
        fl.unffor_unpack(torch.zeros(1, 16, dtype=torch.float64),
                         torch.zeros(1, dtype=torch.float64), 1)
