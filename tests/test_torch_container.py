"""The port's ALPT format vs the JAX package's.

Blobs written by ``alp_tpu.container.compress`` parse in the port and
re-serialise byte for byte; columns carried across by their fields
(``interop.column_from_arrays``) serialise to the same bytes; corrupt
buffers raise ``ValueError`` in the port wherever the JAX package raises
(the checks of ``tests/test_serialization.py``).
"""

import dataclasses
import struct

import numpy as np
import pytest

from alp_tpu import constants as jconstants
from alp_tpu import container as jcontainer

from alp_tpu_torch import constants as C
from alp_tpu_torch import interop
from alp_tpu_torch.columns import route_columns
from alp_tpu_torch.container import CompressedColumn

COLUMNS = route_columns(np.random.default_rng(11),
                        2 * C.N_VECTORS_PER_ROWGROUP)
HEAD = struct.calcsize("<4sHBBQII")


@pytest.fixture(scope="module")
def jax_columns():
    return {name: jcontainer.compress(x) for name, x in COLUMNS.items()}


def _fields(col):
    return {f.name: getattr(col, f.name) for f in dataclasses.fields(col)}


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_jax_blob_parses_and_reserialises(name, jax_columns):
    blob = jax_columns[name].to_bytes()
    ours = CompressedColumn.from_bytes(blob)
    assert ours.to_bytes() == blob
    assert ours.n_rowgroups == jax_columns[name].n_rowgroups
    assert ours.bits_per_value() == jax_columns[name].bits_per_value()


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_column_from_arrays_serialises_like_jax(name, jax_columns):
    ref = jax_columns[name]
    ours = interop.column_from_arrays(_fields(ref))
    assert ours.to_bytes() == ref.to_bytes()


def test_column_from_arrays_missing_field_raises(jax_columns):
    fields = _fields(jax_columns["f64_alp_rd"])
    del fields["rd_dict"]
    with pytest.raises(KeyError):
        interop.column_from_arrays(fields)


def test_v1_blob_without_enc_max(jax_columns):
    ref = dataclasses.replace(jax_columns["bench_bw20_food_prices"],
                              enc_max=None)
    blob = bytearray(ref.to_bytes())
    struct.pack_into("<H", blob, 4, 1)             # version 1
    ours = CompressedColumn.from_bytes(bytes(blob))
    assert ours.enc_max is None
    assert ours.to_bytes()[6:] == bytes(blob)[6:]


def test_constants_equal_jax():
    for ours, ref in ((C.DOUBLE, jconstants.DOUBLE),
                      (C.FLOAT, jconstants.FLOAT)):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(ref, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                assert a.tobytes() == b.tobytes()
            else:
                assert a == b
    assert len(C.FLOAT.fact_arr) == 10
    assert C.ROWGROUP_SAMPLES_JUMP == jconstants.ROWGROUP_SAMPLES_JUMP


def _corrupt(blob, how, col):
    b = bytearray(blob)
    n_rg, n_vec = col.n_rowgroups, col.n_vectors
    if how == "magic":
        b[0] ^= 0xFF
    elif how == "version":
        b[4] ^= 0x7F
    elif how == "dtype_tag":
        b[6] = 7
    elif how == "truncated":
        b = b[:len(b) // 2]
    elif how == "header_only":
        b = b[:HEAD - 1]
    elif how == "n_vectors":
        struct.pack_into("<I", b, 16, n_vec + 5)
    elif how == "n_rowgroups":
        struct.pack_into("<I", b, 20, 1000)
    elif how == "scheme_byte":
        b[HEAD] = 9
    elif how == "bit_width":
        b[HEAD + n_rg * 20 + 2 * n_vec] = 200
    elif how == "rd_right_bw":
        b[HEAD + n_rg * 19] = 99
    elif how == "exc_count":
        esz = 8 if col.dtype == np.float64 else 4
        struct.pack_into("<H", b, HEAD + n_rg * 20 + 3 * n_vec + esz * n_vec,
                         2000)
    elif how == "enc_max":
        esz = 8 if col.dtype == np.float64 else 4
        off = HEAD + n_rg * 20 + 3 * n_vec + esz * n_vec + 2 * n_vec
        struct.pack_into("<Q", b, off, 2**63)
    return bytes(b)


@pytest.mark.parametrize("how", [
    "magic", "version", "dtype_tag", "truncated", "header_only", "n_vectors",
    "n_rowgroups", "scheme_byte", "bit_width", "rd_right_bw", "exc_count",
    "enc_max"])
def test_corrupt_buffers_raise_like_jax(how, jax_columns):
    col = jax_columns["bench_bw20_food_prices"]
    bad = _corrupt(col.to_bytes(), how, col)
    with pytest.raises(ValueError):
        CompressedColumn.from_bytes(bad)
    if how != "header_only":         # the JAX parser raises struct.error
        with pytest.raises(ValueError):
            jcontainer.CompressedColumn.from_bytes(bad)
