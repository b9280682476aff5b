"""The plain reference against numpy and ``math.fsum``, the generators
against their sources' formulas, and the roofline count against
``chip_smoke.py``'s."""

import math
import pathlib
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from harness import roofline, traffic
from reference import plain

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


def _seed_of(seed):
    return lambda name: traffic.subseed(seed, "data", name)


def _odd_values(rng, n):
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-300, 300, n)
    x[:5] = [0.0, -0.0, 5e-324, -2.5e-310, 1.5e307]
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_sum_and_mean_equal_fsum(seed, monkeypatch):
    monkeypatch.setattr(plain, "BLOCK", 333)
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(-1e6, 1e6, 5000), 2)
    x[::7] = _odd_values(rng, len(x[::7]))
    t = torch.from_numpy(x)
    assert plain.exact_sum(t) == math.fsum(x)
    exact = sum(Fraction(v) for v in x.tolist())
    assert plain.exact_mean(t) == float(exact / len(x))
    mask = torch.from_numpy(rng.random(len(x)) < 0.3)
    assert plain.exact_sum(t, mask) == math.fsum(x[mask.numpy()])


def test_exact_sum_specials():
    def f64(*v):
        return torch.tensor(v, dtype=torch.float64)

    assert plain.exact_sum(f64(1.0, math.inf, 2.0)) == math.inf
    assert plain.exact_sum(f64(1.0, -math.inf)) == -math.inf
    assert math.isnan(plain.exact_sum(f64(math.inf, -math.inf)))
    assert math.isnan(plain.exact_mean(f64(1.0, math.nan)))


def test_counts_and_band_sums():
    rng = np.random.default_rng(3)
    x = np.round(rng.uniform(0, 100, 10_000), 2)
    t = torch.from_numpy(x)
    for lo, hi in [(10.0, 20.0), (-math.inf, 24.0), (33.33, 33.33)]:
        sel = (x >= lo) & (x <= hi)
        assert plain.count_between(t, lo, hi) == int(sel.sum())
        assert plain.sum_between(t, lo, hi) == math.fsum(x[sel])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 2, 7, 1000, 1001])
def test_quantiles_equal_numpy(n, dtype):
    rng = np.random.default_rng(n)
    x = np.round(rng.uniform(0, 1e5, n), 2).astype(dtype)
    x[: n // 3] = np.round(x[: n // 3], 0)            # ties
    qs = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.99, 1.0,
          1 / 3, 0.123456789]
    got = plain.quantiles(plain.sort(torch.from_numpy(x)), qs)
    if dtype == np.float64:
        want = np.quantile(x, qs)
    else:
        # numpy widens float32 to the float64 of the q's; the port keeps
        # the lerp in the column's dtype, as the JAX package does
        import alp_tpu_torch
        want = alp_tpu_torch.query_quantile(alp_tpu_torch.compress(x), qs,
                                            device="cpu")
    assert got.dtype == want.dtype == dtype
    ints = np.uint64 if dtype == np.float64 else np.uint32
    assert got.view(ints).tolist() == want.view(ints).tolist()


def test_float32_sums_widen_exactly():
    rng = np.random.default_rng(8)
    x = np.round(rng.uniform(-1e4, 1e4, 4000), 2).astype(np.float32)
    x[:3] = [0.0, -0.0, 1e-45]
    t = torch.from_numpy(x)
    wide = x.astype(np.float64)
    assert plain.exact_sum(t) == math.fsum(wide)
    exact = sum(Fraction(v) for v in wide.tolist())
    assert plain.exact_mean(t) == float(exact / len(x))
    assert plain.count_between(t, -10.5, 10.5) == \
        int(((x >= -10.5) & (x <= 10.5)).sum())


def test_topk_equals_numpy():
    rng = np.random.default_rng(4)
    x = np.round(rng.uniform(0, 50, 3000), 0)
    got = plain.topk(torch.from_numpy(x), 100)
    assert got.tolist() == np.sort(x)[::-1][:100].tolist()
    got = plain.topk(torch.from_numpy(x), 5, largest=False)
    assert got.tolist() == np.sort(x)[:5].tolist()


def test_lineitem_columns_follow_clause_4_2_3(tmp_path):
    sys.path.insert(0, str(ROOT / "perfbench"))
    from harness import spec
    b = spec.Bench(ROOT)
    config = b.workload("lineitem_sf100.agg").config
    gen = b.generator(config["generator"])
    n, seed_of = 100_000, _seed_of(2**31 + 3)
    cols = {c: gen.column(c, config, n, seed_of, "cpu").numpy()
            for c in config["columns"]}
    q, ext = cols["l_quantity"], cols["l_extendedprice"]
    assert q.min() == 1 and q.max() == 50 and (q == np.round(q)).all()
    assert set(np.round(cols["l_discount"] * 100).tolist()) == set(range(11))
    assert set(np.round(cols["l_tax"] * 100).tolist()) == set(range(9))
    cents = np.round(ext * 100).astype(np.int64)
    assert (cents / 100 == ext).all()          # the nearest double
    assert (cents % q.astype(np.int64) == 0).all()
    price = cents // q.astype(np.int64)
    assert price.min() >= 90000 and price.max() <= 90000 + 20000 + 99900
    # the same seed gives the same values; another seed others
    again = gen.column("l_extendedprice", config, n, seed_of, "cpu")
    assert torch.equal(again, torch.from_numpy(ext))
    other = gen.column("l_extendedprice", config, n, _seed_of(5), "cpu")
    assert not torch.equal(other, torch.from_numpy(ext))


def test_distribution_columns_copy_the_route_profiles():
    sys.path.insert(0, str(ROOT / "perfbench"))
    from harness import spec
    b = spec.Bench(ROOT)
    config = b.workload("alp_paper_f64.scan").config
    gen = b.generator(config["generator"])
    n, seed_of = 50_000, _seed_of(11)
    # columns.py route_columns' profiles: range and decimals
    profiles = {"city_temp": (-20, 184.7, 1), "food_prices": (0, 10485.75, 2),
                "bitcoin_price": (0, 10.7, 8), "nyc29": (-74.4, -70.0, 12)}
    for name, (lo, hi, d) in profiles.items():
        x = gen.column(name, config, n, seed_of, "cpu").numpy()
        assert x.min() >= lo and x.max() <= hi
        assert (np.round(x, d) == x).all()
    assert (gen.column("gov26", config, n, seed_of, "cpu") == 0).all()
    rd = gen.column("poi_lat", config, n, seed_of, "cpu").numpy()
    assert abs(rd.mean()) < 0.05 and abs(rd.std() - 1) < 0.05


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_roofline_counts_equal_chip_smokes(dtype):
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import alp_tpu_torch
    from alp_tpu_torch import engine
    assert roofline.SUM_OPS == chip_smoke.SUM_OPS
    assert roofline.KEY_OPS == chip_smoke.KEY_OPS
    assert roofline.RANK_SEARCH == chip_smoke.RANK_SEARCH
    assert roofline.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert roofline.INT32_LANES_PER_SM == chip_smoke.INT32_LANES_PER_SM
    assert roofline.FP64_LANES_PER_SM == chip_smoke.FP64_LANES_PER_SM
    assert roofline.FP32_LANES_PER_SM == chip_smoke.FP32_LANES_PER_SM
    rng = np.random.default_rng(5)
    x = np.round(rng.uniform(0, 1000, 3 * 102400 + 55), 2).astype(dtype)
    x[::1000] = 0.0
    values = torch.from_numpy(x)
    col = alp_tpu_torch.compress(x)
    info = roofline.column_info(col, values)
    assert info.value_bytes == np.dtype(dtype).itemsize
    assert info.f64 == (dtype == np.float64)
    plan = col.plan("cpu")
    bits = plan.run().view(plan.bits_dtype)
    counted = [chip_smoke.sum_ops(plan, c, bits)
               for c in engine.sum_calls(plan)]
    work = roofline.sum_work(info)
    assert work["int_ops"] == sum(c[1] for c in counted)
    assert work["float_ops"] == sum(c[2] for c in counted)
    # the bytes: the format's, below the tensors K7 is handed
    moved = sum(chip_smoke.call_bytes(plan, c)
                for c in engine.sum_calls(plan))
    assert 0.5 * moved < work["bytes"] <= moved
    # K15 at two thresholds: chip_smoke.key_work's operations a value
    key = [chip_smoke.key_work(plan, c, 2) for c in engine.key_calls(plan)]
    kw = roofline.key_work(info, roofline.search_ops(info, 2))
    assert kw["int_ops"] == sum(k[1] for k in key)
    assert kw["float_ops"] == sum(k[2] for k in key)
    # a scan writes every value once at its width
    sw = roofline.scan_work(info)
    assert sw["bytes"] == info.compressed_bytes + x.nbytes


def test_least_seconds_of_a_card_and_of_none():
    work = {"bytes": 3.35e12, "int_ops": 0, "float_ops": 0, "f64": True}
    assert roofline.least_seconds(work, "NVIDIA H100 80GB HBM3") == 1.0
    work = {"bytes": 0, "int_ops": 132 * 64 * 1.98e9, "float_ops": 1,
            "f64": True}
    assert roofline.least_seconds(work, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(1.0)
    # float operations at the FP64 rate on float64, at FP32's on float32
    work = {"bytes": 0, "int_ops": 0, "float_ops": 132 * 64 * 1.98e9,
            "f64": True}
    assert roofline.least_seconds(work, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(1.0)
    work["f64"] = False
    assert roofline.least_seconds(work, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(0.5)
    assert roofline.least_seconds(work, "cpu") is None
