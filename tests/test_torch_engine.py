"""Exact SUM and MEAN: the port against the JAX package and exact math.

Every case of ``tests/test_engine.py``'s SUM tests, on data generated from
a seed with numpy (the datasets are not shipped), at a few vectors a
column.  The JAX package compresses; the port reads the same ALPT bytes.
``alp_tpu_torch.query_sum(col, device="cpu")`` (the kernels' plain
versions) must equal ``alp_tpu.engine.query_sum`` (its Pallas kernels in
interpret mode) and ``math.fsum``, all three by bits; ``query_mean`` must
equal ``alp_tpu.engine.query_mean`` and the exact ``Fraction`` mean
rounded once.  NaN is compared by ``math.isnan``.
"""

import itertools
import math
import struct
from fractions import Fraction

import numpy as np
import pytest
import torch

from alp_tpu import container as jcontainer
from alp_tpu import engine as jengine

import alp_tpu_torch
from alp_tpu_torch import engine
from alp_tpu_torch.kernels import exact_sum as kes


def _same(a: float, b: float) -> bool:
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return struct.pack("<d", a) == struct.pack("<d", b)


def _special(x: np.ndarray):
    """The IEEE answer of a column holding NaN or infinities, else None."""
    if np.isnan(x).any() or (np.isposinf(x).any() and np.isneginf(x).any()):
        return float("nan")
    if np.isposinf(x).any():
        return float("inf")
    if np.isneginf(x).any():
        return float("-inf")
    return None


def _fsum(x: np.ndarray) -> float:
    special = _special(x)
    return special if special is not None else math.fsum(
        x.astype(np.float64).tolist())


def _fraction_mean(x: np.ndarray) -> float:
    if not len(x):
        return float("nan")
    special = _special(x)
    if special is not None:
        return special
    total = sum(map(Fraction, x.astype(np.float64).tolist()), Fraction(0))
    return float(total / len(x))


# the seeds of tests/test_engine.py's wide columns, which the planner keeps
# in ALP at bit widths above 32 (mid64 and midc96 buckets in the JAX plan)
SEEDS = {"wide_mid64": 311, "wide_midc96": 320}


def _case(name: str) -> np.ndarray:
    rng = np.random.default_rng(SEEDS.get(name, sum(map(ord, name))))
    if name.startswith("ragged_") and name[7:].isdigit():
        n = int(name[7:])
        return np.round(rng.uniform(-3, 3, n), 2)
    if name == "ragged_f32":
        return np.round(rng.uniform(0, 50, 2500), 2).astype(np.float32)
    if name == "ragged_rd":
        return rng.uniform(-1, 1, 1500)
    if name == "exceptions":
        x = np.round(rng.uniform(-10, 10, 4096), 2)
        x[[5, 700, 2049]] = [np.pi, 1e300, -0.0]
        return x
    if name == "adversarial":
        x = np.zeros(2048)
        x[:7] = [1e300, -1e300, 1.0, 2.0 ** -1000, 1e16, 1.0, -1e16]
        return x
    if name == "subnormal_const":
        return np.full(1024, 5e-324)
    if name == "subnormal_alp":
        x = np.round(rng.uniform(-5, 5, 2048), 2)
        x[[17, 900]] = [5e-324, -3e-310]
        return x
    if name == "subnormal_rd":
        x = rng.standard_normal(2048)
        x[[17, 900]] = [5e-324, -3e-310]
        return x
    if name == "subnormal_f32_rd":
        x = rng.standard_normal(2048).astype(np.float32)
        x[11] = np.float32(1e-44)
        return x
    if name in ("tail_pi", "tail_negzero"):
        x = np.round(rng.uniform(-5, 5, 1500), 2)
        x[-1] = np.pi if name == "tail_pi" else -0.0
        return x
    if name == "tail_rd_pi":
        x = rng.standard_normal(1500)
        x[-1] = np.pi
        return x
    if name.startswith("specials_"):
        x = np.round(rng.uniform(-100, 100, 3000), 1)
        for tag, value in (("nan", np.nan), ("pinf", np.inf),
                           ("ninf", -np.inf)):
            if tag in name.split("_")[2:]:
                x[rng.integers(0, len(x))] = value
        if name.split("_")[1] == "rd":
            x[:] = np.where(np.isfinite(x), rng.standard_normal(len(x)), x)
        return x
    if name == "f32_specials":
        x = np.round(rng.uniform(-50, 50, 1500), 2).astype(np.float32)
        x[7] = np.float32(np.inf)
        return x
    if name == "wide_mid64":
        return np.round(rng.uniform(0, 1e10, 3000), 2)
    if name == "wide_midc96":
        return np.round(rng.uniform(-1e9, 1e9, 3000), 2)
    if name == "f32_alp":
        return np.round(rng.uniform(0, 100, 4096), 2).astype(np.float32)
    if name == "f32_rd":
        return (rng.standard_normal(3000) * 1e8).astype(np.float32)
    if name == "mixed_alp_rd":
        x = np.round(rng.uniform(0, 100, 100 * 1024 + 1500), 2)
        x[100 * 1024:] = rng.standard_normal(1500)
        return x
    if name == "empty":
        return np.zeros(0)
    if name == "food_prices_like":
        x = np.round(rng.uniform(0, 10485.75, 8 * 1024 - 77), 2)
        x[rng.integers(0, len(x), 5)] = np.round(rng.uniform(1e5, 1e6, 5), 3)
        return x
    raise KeyError(name)


SPECIAL_SETS = [s for k in range(4)
                for s in itertools.combinations(("nan", "pinf", "ninf"), k)]
CASES = (
    [f"ragged_{n}" for n in (1, 300, 1023, 1025, 1500, 4113)]
    + ["ragged_f32", "ragged_rd", "exceptions", "adversarial",
       "subnormal_const", "subnormal_alp", "subnormal_rd",
       "subnormal_f32_rd", "tail_pi", "tail_negzero", "tail_rd_pi"]
    + ["_".join(("specials", "alp") + s) for s in SPECIAL_SETS]
    + ["_".join(("specials", "rd") + s) for s in SPECIAL_SETS[1:]]
    + ["f32_specials", "wide_mid64", "wide_midc96", "f32_alp", "f32_rd",
       "mixed_alp_rd", "empty", "food_prices_like"])


@pytest.mark.parametrize("name", CASES)
def test_sum_and_mean_equal_jax_and_exact(name):
    x = _case(name)
    jcol = jcontainer.compress(x)
    col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
    got = alp_tpu_torch.query_sum(col, device="cpu")
    assert _same(got, jengine.query_sum(jcol)), name
    assert _same(got, _fsum(x)), (name, got, _fsum(x))
    mean = alp_tpu_torch.query_mean(col, device="cpu")
    assert _same(mean, jengine.query_mean(jcol)), name
    assert _same(mean, _fraction_mean(x)), (name, mean, _fraction_mean(x))


def test_cases_reach_their_routes():
    """The cases drive what their names say: both schemes, the wide ALP
    bit widths, exceptions and a tail."""
    def schemes(name):
        return set(jcontainer.compress(_case(name)).rg_scheme.tolist())
    assert schemes("mixed_alp_rd") == {1, 2}
    for name in ("ragged_rd", "subnormal_rd", "subnormal_f32_rd", "f32_rd",
                 "specials_rd_nan"):
        assert 1 in schemes(name), name
    for name in ("exceptions", "subnormal_alp", "f32_alp", "tail_pi"):
        assert schemes(name) == {2}, name
    for name in ("wide_mid64", "wide_midc96"):
        col = jcontainer.compress(_case(name))
        assert set(col.rg_scheme.tolist()) == {2}, name
        assert col.bit_width.max() > 32, name
    col = jcontainer.compress(_case("tail_pi"))
    assert col.exc_count[-1] > 0 and col.n_values % 1024


def test_sum_matches_the_host_mirror():
    """The windows joined equal the per-value host mirror's integer."""
    x = _case("adversarial")
    col = alp_tpu_torch.compress(x)
    got = engine.join_totals(
        engine.exact_sum_totals(col.plan("cpu")).tolist(), x.dtype)
    assert got == engine.host_sum_raw(x)


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    col = alp_tpu_torch.compress(np.linspace(0, 1, 3000))
    for query in (alp_tpu_torch.query_sum, alp_tpu_torch.query_mean):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            query(col)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            query(col, device="cuda")


def test_too_many_values_raise():
    """One kernel call sums fewer than 2^31 values: more could overflow
    its int64 totals.  A column of more is summed in runs, each into its
    own total (tests/test_torch_exact_sum.py::
    test_sum_in_runs_equals_one_total)."""
    with pytest.raises(ValueError, match="2\\^31"):
        kes._check_size(1 << 21, 1 << 31)
    kes._check_size((1 << 21) - 1, 1 << 40)
