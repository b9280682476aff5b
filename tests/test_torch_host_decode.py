"""The port's host decode engine against the JAX package's, on the CPU.

* Every host entry of ``alp_tpu_torch.native`` that decodes or packs one
  bucket (``ffor``, ``unffor``, ``ffor_pv``, ``falp_f64``, ``falp_f32``,
  ``rd_decode``) and the rowgroup planner and encoder of one candidate set
  (``init_f64``, ``encode_f64``) equal ``alp_tpu.native``'s same function
  on the same seeded inputs by bits.
* ``alp_tpu_torch.decompress_host(col)`` equals
  ``alp_tpu.container.decompress`` of the same blob, the input and the
  port's ``decompress(col, "cpu")`` by bits on every route column (bit
  widths 0, <= 32, 33-52 and 53-64, f64 and f32 ALP_RD, f32 ALP, NaN,
  +-Inf, -0.0 and a tail, mixed ALP and ALP_RD rowgroups), on empty
  columns and on columns with vectors made only of exceptions.
* A failed build of the engine raises ``NativeBuildError`` out of
  ``decompress_host``: nothing falls back.
"""

import numpy as np
import pytest

from alp_tpu import container as jcontainer
from alp_tpu import native as jnative

import alp_tpu_torch
from alp_tpu_torch import constants as C
from alp_tpu_torch import native
from alp_tpu_torch.columns import route_columns

ROUTE_VECTORS = 250                  # three rowgroups: the mixed column
ROUTES = tuple(route_columns(np.random.default_rng(0), 1))
UINT = {np.dtype(np.float64): np.uint64, np.dtype(np.float32): np.uint32}

FFOR_CASES = [(ut, bw) for ut, bws in (
    (np.uint64, (0, 5, 17, 33, 52, 64)),
    (np.uint32, (0, 3, 17, 32)),
    (np.uint16, (0, 2, 9, 16))) for bw in bws]


def _ints(rng, ut, bw, shape):
    """Seeded unsigned ints of ``bw`` bits (all bits at bw 64)."""
    if bw == 0:
        return np.zeros(shape, ut)
    if bw == 64:
        return rng.integers(0, 2**64, shape, dtype=np.uint64).astype(ut)
    return rng.integers(0, 1 << bw, shape, dtype=np.uint64).astype(ut)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("ut,bw", FFOR_CASES,
                         ids=[f"{np.dtype(u).name}-bw{b}"
                              for u, b in FFOR_CASES])
def test_ffor_and_unffor_equal_the_reference(ut, bw):
    rng = np.random.default_rng(bw * 7 + np.dtype(ut).itemsize)
    base = ut(rng.integers(0, 1000))
    vals = _ints(rng, ut, bw, (5, 1024)) + base
    packed = native.ffor(vals, bw, base)
    assert _same(packed, jnative.ffor(vals, bw, base))
    back = native.unffor(packed, bw, base, ut)
    assert _same(back, jnative.unffor(packed, bw, base, ut))
    assert _same(back, vals)


@pytest.mark.parametrize("bw", [0, 7, 33, 64])
def test_ffor_pv_equals_the_reference(bw):
    rng = np.random.default_rng(bw)
    bases = rng.integers(-2**40, 2**40, 6).astype(np.int64)
    vals = (_ints(rng, np.uint64, bw, (6, 1024))
            + bases.view(np.uint64)[:, None]).view(np.int64)
    packed = native.ffor_pv(vals, bw, bases)
    assert _same(packed, jnative.ffor_pv(vals, bw, bases))
    for row, base in zip(range(6), bases.view(np.uint64)):
        back = native.unffor(packed[row:row + 1], bw, base, np.uint64)
        assert _same(back[0].view(np.int64), vals[row])


def _falp_args(f64: bool, seed: int):
    """Seeded ``falp`` arguments of 40 vectors (OpenMP above 32) at mixed
    bit widths, bases, factors and exponents."""
    rng = np.random.default_rng(seed)
    tc = C.DOUBLE if f64 else C.FLOAT
    ut, L = (np.uint64, 16) if f64 else (np.uint32, 32)
    n = 40
    bws = rng.integers(0, 40 if f64 else 25, n).astype(np.uint8)
    bws[:3] = (0, 1, 33 if f64 else 24)
    words = [_ints(rng, ut, 64 if f64 else 32, int(b) * L) for b in bws]
    offsets = np.zeros(n, np.int32)
    np.cumsum([len(w) for w in words[:-1]], out=offsets[1:])
    bases = rng.integers(-1000, 1000, n).astype(tc.st)
    facts = tc.fact_arr[rng.integers(0, len(tc.fact_arr), n)]
    fracs = tc.frac_arr[rng.integers(0, len(tc.frac_arr), n)]
    return (np.concatenate(words), offsets, bws, bases, facts, fracs)


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_falp_equals_the_reference(f64):
    args = _falp_args(f64, 11 if f64 else 12)
    fn, ref = ((native.falp_f64, jnative.falp_f64) if f64
               else (native.falp_f32, jnative.falp_f32))
    want = ref(*args)
    got = fn(*args)
    assert _same(got, want)
    dest = np.full_like(want, 7)
    assert fn(*args, out=dest) is dest and _same(dest, want)


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_falp_refuses_an_out_that_does_not_fit(f64):
    args = _falp_args(f64, 13)
    fn, dt = ((native.falp_f64, np.float64) if f64
              else (native.falp_f32, np.float32))
    other = np.float32 if f64 else np.float64
    for out in (np.empty((39, 1024), dt), np.empty((40, 1024), other),
                np.empty((40, 2048), dt)[:, ::2]):
        with pytest.raises(ValueError):
            fn(*args, out=out)


@pytest.mark.parametrize("f64,rbw,lbw", [
    (True, 48, 3), (True, 52, 0), (True, 63, 1), (True, 0, 2),
    (False, 16, 3), (False, 29, 1), (False, 0, 0)])
def test_rd_decode_equals_the_reference(f64, rbw, lbw):
    rng = np.random.default_rng(rbw * 17 + lbw)
    ut, L = (np.uint64, 16) if f64 else (np.uint32, 32)
    n = 12                                        # OpenMP above 8
    right = _ints(rng, ut, 64 if f64 else 32, (n, rbw * L))
    left = _ints(rng, np.uint16, 16, (n, lbw * 64))
    dicts = _ints(rng, np.uint16, 16, (n, 8))
    sizes = rng.integers(0, 9, n).astype(np.uint8)
    sizes[:2] = (0, 8)
    got = native.rd_decode(right, left, dicts, sizes, rbw, lbw, ut)
    assert _same(got, jnative.rd_decode(right, left, dicts, sizes, rbw,
                                        lbw, ut))


@pytest.mark.parametrize("kind", ["decimals", "normal", "integers"])
def test_init_f64_and_encode_f64_equal_the_reference(kind):
    rng = np.random.default_rng(len(kind))
    n = 3 * C.VECTOR_SIZE * C.N_VECTORS_PER_ROWGROUP // 2
    x = {"decimals": lambda: np.round(rng.uniform(-50, 50, n), 2),
         "normal": lambda: rng.standard_normal(n),
         "integers": lambda: rng.integers(-2**40, 2**40, n).astype(
             np.float64)}[kind]()
    x[rng.choice(n, 50, replace=False)] = rng.standard_normal(50)
    x[:3] = (np.nan, -np.inf, -0.0)
    for offset in (0, C.VECTOR_SIZE * C.N_VECTORS_PER_ROWGROUP):
        scheme, combos, k = native.init_f64(x, offset)
        want = jnative.init_f64(x, offset)
        assert (scheme, k) == (want[0], want[2])
        assert _same(combos, want[1])
    vectors = x[:40 * C.VECTOR_SIZE].reshape(40, C.VECTOR_SIZE)
    got = native.encode_f64(vectors, combos)
    want = jnative.encode_f64(vectors, combos)
    assert list(got) == list(want)
    counts = got["exc_count"].astype(np.int64)
    assert counts.sum() > 0
    for key in ("fac", "exp", "bit_width", "base", "encoded", "exc_count"):
        assert _same(got[key], want[key]), key
    for key in ("exc_values", "exc_positions"):   # rows past exc_count are
        for row, c in enumerate(counts):          # scratch
            assert _same(got[key][row, :c], want[key][row, :c]), key


def _reference(col):
    return jcontainer.decompress(
        jcontainer.CompressedColumn.from_bytes(col.to_bytes()))


def _check(col, x):
    got = alp_tpu_torch.decompress_host(col)
    ut = UINT[np.dtype(x.dtype)]
    assert isinstance(got, np.ndarray) and got.dtype == x.dtype
    assert got.shape == (len(x),)
    assert _same(got.view(ut), x.view(ut))
    assert _same(got.view(ut), _reference(col).view(ut))
    assert _same(got.view(ut), alp_tpu_torch.decompress(
        col, "cpu").numpy().view(ut))
    return got


@pytest.mark.parametrize("name", ROUTES)
def test_decompress_host_equals_the_reference_on_every_route(name):
    x = route_columns(np.random.default_rng(0), ROUTE_VECTORS)[name]
    col = alp_tpu_torch.compress(x)
    vec_rg = np.arange(col.n_vectors) // C.N_VECTORS_PER_ROWGROUP
    rd = col.rg_scheme[vec_rg] == C.SCHEME_ALP_RD
    if "alp_rd" in name:
        assert rd.any() and col.exc_count[rd].sum() > 0
    if name == "f64_alp_bw53_64":
        assert col.bit_width[~rd].max() >= 53
    _check(col, x)
    # and from the blob, where the exceptions are views of its bytes
    _check(alp_tpu_torch.CompressedColumn.from_bytes(col.to_bytes()), x)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_decompress_host_of_an_empty_column(dtype):
    x = np.zeros(0, dtype)
    _check(alp_tpu_torch.compress(x), x)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_decompress_host_of_vectors_made_of_exceptions(dtype):
    """Rowgroups ALP, ALP_RD, ALP, ALP: the exceptions of the third land
    in rows of the ALP vectors that are not their vector indices."""
    rng = np.random.default_rng(4)
    x = np.round(rng.uniform(0, 100, 4 * 102400 + 77), 2).astype(dtype)
    x[102400:2 * 102400] = rng.standard_normal(102400)
    x[5 * 1024:6 * 1024] = np.nan
    x[7 * 1024:8 * 1024] = rng.standard_normal(1024)
    x[250 * 1024:251 * 1024] = np.inf
    x[-77:] = -0.0
    col = alp_tpu_torch.compress(x)
    assert list(col.rg_scheme[:3]) == [C.SCHEME_ALP, C.SCHEME_ALP_RD,
                                       C.SCHEME_ALP]
    assert (col.exc_count[[5, 7, 250]] == C.VECTOR_SIZE).all()
    _check(col, x)


def test_decompress_host_clamps_a_factor_index_past_the_table():
    """A stored f32 factor index past FACT (10 entries) reads the last
    entry, as the reference's host decompress does."""
    x = np.round(np.random.default_rng(5).uniform(0, 9, 3000), 1).astype(
        np.float32)
    col = alp_tpu_torch.compress(x)
    col.fac = col.fac.copy()
    col.fac[1] = len(C.FLOAT.fact_arr)
    got = alp_tpu_torch.decompress_host(col)
    assert _same(got.view(np.uint32), _reference(col).view(np.uint32))
    assert not _same(got.view(np.uint32), x.view(np.uint32))


def test_a_failed_build_raises_out_of_decompress_host(monkeypatch):
    col = alp_tpu_torch.compress(np.round(np.linspace(0, 9, 5000), 2))

    def refuse(src):
        raise native.NativeBuildError(f"g++ failed on {src.name}")

    monkeypatch.setattr(native, "_build", refuse)
    native.lib.cache_clear()
    try:
        with pytest.raises(native.NativeBuildError, match="alpcore"):
            alp_tpu_torch.decompress_host(col)
    finally:
        native.lib.cache_clear()


@pytest.mark.parametrize("n", [9, 1000])
def test_converted_arguments_live_through_the_call(n):
    """Arguments of another dtype are converted, and the copies live until
    the engine returns (OpenMP above 8 vectors: the threads' start may
    reuse freed memory)."""
    rng = np.random.default_rng(n)
    right = _ints(rng, np.uint64, 64, (n, 53 * 16))
    left = _ints(rng, np.uint16, 16, (n, 3 * 64))
    dicts = _ints(rng, np.uint16, 16, (n, 8))
    sizes = rng.integers(1, 9, n).astype(np.uint8)
    want = jnative.rd_decode(right, left, dicts, sizes, 53, 3, np.uint64)
    for _ in range(3):
        got = native.rd_decode(right, left.astype(np.int64),
                               dicts.astype(np.int32), sizes, 53, 3,
                               np.uint64)
        assert _same(got, want)
    words, offsets, bws, bases, facts, fracs = _falp_args(False, n)
    want = jnative.falp_f32(words, offsets, bws, bases, facts, fracs)
    for _ in range(3):
        got = native.falp_f32(words.astype(np.uint64), offsets.astype(int),
                              bws.astype(int), bases.astype(int),
                              facts.astype(int), fracs.astype(np.float64))
        assert _same(got, want)
