"""Windows, COUNT DISTINCT and ``groupby_keys``: the port against the JAX
package.

The route columns of ``tests/test_torch_query.py`` (see there), made from a
seed with numpy, are compressed by the JAX package and read by the port
from the same ALPT bytes.  ``alp_tpu_torch.engine.query_window``,
``query_distinct`` and ``groupby_keys`` with ``device="cpu"`` (the kernels'
plain versions) must equal ``alp_tpu.engine``'s answers by bits
(tolerance 0; NaN equals NaN, the dtypes equal): tumbling windows at a
multiple of 1024 rows and at a non-multiple, sliding windows, windows
longer than the column and an empty column; DISTINCT over NaN of both
signs and with payloads, a signaling NaN and both zeros.  Each window's
SUM must also equal ``math.fsum`` of its rows.
"""

import math

import numpy as np
import pytest

from alp_tpu import container as jcontainer
from alp_tpu import engine as jengine

import alp_tpu_torch
from alp_tpu_torch import engine
from test_torch_groupby import _fsum_group, _same
from test_torch_query import NAMES, _columns

CPU = {"device": "cpu"}
# (window, hop): tumbling at a multiple of 1024 and not, sliding (hop
# dividing the window, at and off vector boundaries), longer than n
WINDOWS = [(2048, None), (1000, None), (3000, 750), (4096, 1024),
           (10 ** 6, None), (10 ** 6, 250000)]


@pytest.mark.parametrize("name", NAMES)
def test_windows_equal_jax_and_fsum(name):
    x, jcol, col = _columns(name)
    n = len(x)
    for window, hop in WINDOWS:
        got = engine.query_window(col, window, hop=hop, **CPU)
        assert _same(got, jengine.query_window(jcol, window, hop=hop)), (
            name, window, hop)
        step = window if hop is None else hop
        starts = range(0, max(n - window, 0) + step, step)
        assert len(got["sum"]) == len(starts)
        for i, s in enumerate(starts):
            want = _fsum_group(x[s:s + window])
            have = float(got["sum"][i])
            assert (math.isnan(have) and math.isnan(want)) or have == want
            assert got["count"][i] == len(x[s:s + window])


def test_window_validation_and_empty_column_equal_jax():
    x, jcol, col = _columns("bw_le32")
    for window, hop in ((0, None), (-5, None), (1000, 300), (1000, 0)):
        with pytest.raises(ValueError) as mine:
            engine.query_window(col, window, hop=hop, **CPU)
        with pytest.raises(ValueError) as theirs:
            jengine.query_window(jcol, window, hop=hop)
        assert str(mine.value) == str(theirs.value)
    for dtype in (np.float64, np.float32):
        jcol = jcontainer.compress(np.zeros(0, dtype))
        col = alp_tpu_torch.CompressedColumn.from_bytes(jcol.to_bytes())
        for window, hop in ((100, None), (100, 25)):
            assert _same(engine.query_window(col, window, hop=hop, **CPU),
                         jengine.query_window(jcol, window, hop=hop))
        assert engine.query_distinct(col, **CPU) == jengine.query_distinct(
            jcol) == 0


@pytest.mark.parametrize("name", NAMES)
def test_distinct_equals_jax_and_numpy(name):
    """-0.0 equals 0.0, every NaN (both signs, any payload) is one value."""
    x, jcol, col = _columns(name)
    got = engine.query_distinct(col, **CPU)
    assert got == jengine.query_distinct(jcol)
    finite_or_inf = x[~np.isnan(x)]
    want = len(np.unique(finite_or_inf)) + int(np.isnan(x).any())
    assert got == want


def test_groupby_keys_equal_jax():
    """Keys of a small column (repeats, both zeros, NaN of both signs and a
    payload), and a group-by of another column by them."""
    rng = np.random.default_rng(14)
    n = 3000
    kvals = rng.choice([1.5, 2.25, -3.0, 10.0, 0.0, -0.0, np.nan, -np.nan],
                       n)
    kvals.view(np.uint64)[7] = 0x7FF0000000000123
    vals = np.round(rng.normal(0.0, 1.0, n), 2)
    jk = jcontainer.compress(kvals)
    kcol = alp_tpu_torch.CompressedColumn.from_bytes(jk.to_bytes())
    keys, uniques = engine.groupby_keys(kcol, **CPU)
    jkeys, juniques = jengine.groupby_keys(jk)
    assert keys.dtype == jkeys.dtype == np.int64
    assert np.array_equal(keys, jkeys)
    assert np.array_equal(uniques.view(np.uint64), juniques.view(np.uint64))
    jv = jcontainer.compress(vals)
    vcol = alp_tpu_torch.CompressedColumn.from_bytes(jv.to_bytes())
    assert _same(engine.query_groupby(vcol, keys, len(uniques), **CPU),
                 jengine.query_groupby(jv, jkeys, len(juniques)))
