"""The whole slice: compress, carry across, decode; port vs JAX package.

Each route column (two rowgroups) is compressed by the JAX package and
carried to the port both ways, as ALPT bytes and as fields
(``interop.column_from_arrays``).  ``alp_tpu_torch.decompress(col,
device="cpu")`` must equal, bit for bit, the input,
``alp_tpu.container.decompress`` and ``alp_tpu.kernels.decode.
decompress_device`` (the fused Pallas decode, interpret mode here).
"""

import dataclasses

import numpy as np
import pytest
import torch

from alp_tpu import container as jcontainer
from alp_tpu.kernels import decode as jdecode

import alp_tpu_torch
from alp_tpu_torch import constants as C
from alp_tpu_torch import interop
from alp_tpu_torch.columns import route_columns, tile_column
from alp_tpu_torch.kernels import decode

COLUMNS = route_columns(np.random.default_rng(21),
                        2 * C.N_VECTORS_PER_ROWGROUP)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint64 if a.dtype.itemsize == 8 else np.uint32)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_decode_equals_jax_both_bridges(name):
    x = COLUMNS[name]
    jcol = jcontainer.compress(x)
    host = _bits(jcontainer.decompress(jcol))
    fused = _bits(jdecode.decompress_device(jcol)).reshape(-1)[:len(x)]
    assert np.array_equal(host, _bits(x))
    assert np.array_equal(fused, host)
    from_bytes = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
    from_fields = interop.column_from_arrays(
        {f.name: getattr(jcol, f.name) for f in dataclasses.fields(jcol)})
    for col in (from_bytes, from_fields):
        out = alp_tpu_torch.decompress(col, device="cpu")
        assert out.shape == (len(x),) and out.device.type == "cpu"
        assert out.dtype == (torch.float64 if x.dtype == np.float64
                             else torch.float32)
        assert np.array_equal(_bits(out.numpy()), host)


@pytest.mark.parametrize("name", ["f64_mixed_alp_rd", "f32_alp_rd"])
def test_decompress_device_rows_equal_jax(name):
    jcol = jcontainer.compress(COLUMNS[name])
    col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
    got = decode.decompress_device(col, "cpu")
    assert got.shape == (col.n_vectors, 1024)
    assert np.array_equal(_bits(got.numpy()),
                          _bits(jdecode.decompress_device(jcol)))


def test_plan_buckets_by_scheme_and_width():
    col = alp_tpu_torch.compress(COLUMNS["f64_mixed_alp_rd"])
    plan = decode.build_plan(col, "cpu")
    keys = [(b.scheme, b.bw, b.lbw) for b in plan.buckets]
    assert len(keys) == len(set(keys))
    assert {b.scheme for b in plan.buckets} == {C.SCHEME_ALP, C.SCHEME_ALP_RD}
    rows = torch.cat([b.rows for b in plan.buckets]).sort().values
    assert torch.equal(rows, torch.arange(col.n_vectors))


def test_tiled_column_decodes_to_tiled_input():
    x = COLUMNS["bench_bw30_bitcoin"]
    col = tile_column(alp_tpu_torch.compress(x), 450)
    assert col.n_rowgroups == 5
    out = alp_tpu_torch.decompress(col, device="cpu")
    assert np.array_equal(_bits(out.numpy()),
                          _bits(np.tile(x, 3)[:450 * 1024]))


def test_port_roundtrip_of_its_own_blobs():
    for name, x in COLUMNS.items():
        blob = alp_tpu_torch.compress(x).to_bytes()
        col = alp_tpu_torch.CompressedColumn.from_bytes(blob)
        out = alp_tpu_torch.decompress(col, device="cpu")
        assert np.array_equal(_bits(out.numpy()), _bits(x)), name
