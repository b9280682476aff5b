"""Port host compress vs the JAX package's: byte-identical ALPT blobs.

Every route column of ``alp_tpu_torch.columns`` (two rowgroups each) goes
through ``alp_tpu_torch.compress`` and ``alp_tpu.container.compress``; the
serialised blobs must be equal byte for byte, and each column must reach
the route it is named for.
"""

import numpy as np
import pytest

from alp_tpu import container as jcontainer

import alp_tpu_torch
from alp_tpu_torch import constants as C
from alp_tpu_torch.columns import route_columns

N_VECTORS = 2 * C.N_VECTORS_PER_ROWGROUP
COLUMNS = route_columns(np.random.default_rng(7), N_VECTORS)


def _alp_bit_widths(col):
    vec_rg = np.arange(col.n_vectors) // C.N_VECTORS_PER_ROWGROUP
    return set(col.bit_width[col.rg_scheme[vec_rg] == C.SCHEME_ALP].tolist())


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_compress_bytes_equal_jax(name):
    x = COLUMNS[name]
    ours = alp_tpu_torch.compress(x)
    ref = jcontainer.compress(x)
    assert ours.to_bytes() == ref.to_bytes()
    assert ours.bits_per_value() == ref.bits_per_value()
    assert ours.compressed_size_bytes() == ref.compressed_size_bytes()


ROUTES = {
    # name: (schemes, predicate on the ALP bit widths)
    "bench_bw0_gov26": ({C.SCHEME_ALP}, lambda b: b == {0}),
    "bench_bw11_city_temperature": ({C.SCHEME_ALP}, lambda b: b == {11}),
    "bench_bw20_food_prices": ({C.SCHEME_ALP}, lambda b: b == {20}),
    "bench_bw30_bitcoin": ({C.SCHEME_ALP}, lambda b: b == {30}),
    "bench_bw42_nyc29": ({C.SCHEME_ALP}, lambda b: 42 in b),
    "f64_alp_bw53_64": ({C.SCHEME_ALP}, lambda b: max(b) >= 53),
    "f64_alp_rd": ({C.SCHEME_ALP_RD}, lambda b: b == set()),
    "f32_alp": ({C.SCHEME_ALP}, lambda b: len(b) > 0),
    "f32_alp_rd": ({C.SCHEME_ALP_RD}, lambda b: b == set()),
    "f64_mixed_alp_rd": ({C.SCHEME_ALP, C.SCHEME_ALP_RD},
                         lambda b: len(b) > 0),
    "f64_specials_tail": ({C.SCHEME_ALP}, lambda b: len(b) > 0),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_column_reaches_its_route(name):
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    schemes, widths_ok = ROUTES[name]
    assert set(col.rg_scheme.tolist()) == schemes
    assert widths_ok(_alp_bit_widths(col)), _alp_bit_widths(col)
    if name == "f64_specials_tail":
        assert col.n_values % C.VECTOR_SIZE == 333
        assert np.isnan(x).any() and np.isinf(x).any()
        assert (np.signbit(x) & (x == 0)).any()
        assert col.exc_count.sum() > 0


@pytest.mark.parametrize("n", [0, 1, 1023, 1025, 3 * 1024 + 5])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_compress_short_columns_equal_jax(n, dtype):
    x = np.round(np.random.default_rng(n).uniform(-5, 5, n), 2).astype(dtype)
    assert (alp_tpu_torch.compress(x).to_bytes()
            == jcontainer.compress(x).to_bytes())


def test_compress_rejects_other_dtypes():
    with pytest.raises(TypeError):
        alp_tpu_torch.compress(np.arange(10, dtype=np.int64))
