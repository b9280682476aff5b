"""Device compress of float32 columns (K12-K14 and the planner) on the CPU.

On the CPU every kernel wrapper runs its plain PyTorch version.  Held,
with no tolerance (the codec is lossless: bytes and integers are equal):

* the blob of ``compress_device`` (from a numpy array and from a tensor of
  values) and of ``compress(x, device="cpu")`` equals
  ``alp_tpu.container.compress``'s on both f32 route columns (two full
  rowgroups, so the device planner, vote and accept scan run), on the
  columns of tests/test_encode_kernel.py:284-300, on -0.0, NaN and +-Inf
  at sampled positions, on the column where host compress takes ALP_RD
  because of -0.0 samples, on scaled values that cross +-2^31, on
  subnormals at sampled positions, and on 1-, 1025-value and
  two-rowgroups-and-a-tail columns; one also equals
  ``alp_tpu.device_compress.compress_device``'s (interpret mode);
* K12's plain version equals ``alp_encode_f32_tiles_stats`` +
  ``finalize_encode_stats32`` and ``alp_encode_f32_tiles``, and the
  oracle's encode_vector at the pair (10, 10), which no TPU kernel takes;
* K13's plain version equals ``ffor_tile(..., element_bits=32)`` at bit
  widths 1, 15, 16, 17, 31 and 32;
* K14's plain version equals ``first_level_scores_f32`` and
  ``second_level_scores_f32`` on samples without special values, and the
  oracle's encode_value_safe / decode_value on -0.0, NaN, +-Inf,
  subnormals, values near +-2^31 and the pair (10, 10).

``tests/test_torch_cuda.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alp_tpu import constants as JC
from alp_tpu import container as jcontainer
from alp_tpu import device_compress as jdc
from alp_tpu.kernels import encode as jencode
from alp_tpu.kernels import falp as jfalp
from alp_tpu.kernels import layout
from alp_tpu.kernels import score as jscore
from alp_tpu.ops import alp as jalp
from alp_tpu.oracle import core as ocore

import alp_tpu_torch
from alp_tpu_torch import constants as C
from alp_tpu_torch import device_compress as dc
from alp_tpu_torch.columns import route_columns
from alp_tpu_torch.kernels import encode as kenc
from alp_tpu_torch.kernels import ffor as kffor
from alp_tpu_torch.kernels import score as kscore
from alp_tpu_torch.ops import alp as oalp

tc = C.FLOAT
RG = C.N_VECTORS_PER_ROWGROUP
SAMPLED = (np.arange(0, RG, 12)[:, None] * 1024
           + np.arange(0, 1024, 32)[None, :]).reshape(-1)   # one rowgroup's
f32 = np.float32


def negative_zero_column() -> np.ndarray:
    """-0.0 at 30 % of the 32-value stride positions: the host search
    counts them with n = INT32_MIN, so every rowgroup takes ALP_RD; JAX's
    TPU scorer calls them exceptions and keeps ALP."""
    rng = np.random.default_rng(5)
    x = np.round(rng.uniform(0, 100, 200 * 1024), 1).astype(f32)
    pos = np.arange(0, len(x), 32)
    x[pos[rng.random(len(pos)) < 0.3]] = -0.0
    return x


def _columns() -> dict:
    cols = {name: x for name, x in
            route_columns(np.random.default_rng(7), 2 * RG).items()
            if x.dtype == np.float32}
    rng = np.random.default_rng(19)                # test_encode_kernel.py
    for i, x in enumerate([
            np.round(rng.uniform(-900, 900, 3000), 2).astype(f32),
            np.round(rng.uniform(0, 10, 2048), 1).astype(f32),
            np.array([1.5, -0.0, np.nan, np.inf, 2.25] * 300, f32),
            np.full(1500, f32(7.5)),
            np.concatenate([np.round(rng.uniform(-50, 50, 52 * 1024),
                                     d).astype(f32) for d in (1, 2, 0, 2)]),
            np.concatenate([np.full(103 * 1024, f32(1e-44)),
                            np.round(rng.uniform(0, 9, 103 * 1024),
                                     1).astype(f32)])]):
        cols[f"encode_kernel_{i}"] = x
    rng = np.random.default_rng(77)
    spec = np.round(rng.uniform(-50, 50, 2 * RG * 1024 + 5), 1).astype(f32)
    for rg in range(2):
        pick = rng.choice(SAMPLED, 12, replace=False) + rg * RG * 1024
        spec[pick] = np.tile([-0.0, np.nan, np.inf, -np.inf], 3)
    spec[rng.choice(len(spec), 50, replace=False)] = np.nan
    cols["specials_sampled"] = spec
    cols["negative_zero_rd"] = negative_zero_column()
    wide = np.round(rng.uniform(-100, 100, 2 * RG * 1024), 2).astype(f32)
    big = np.array([2.2e7, -2.2e7, 2.147e7, -2.1475e7, 2147483520.0,
                    -2147483648.0, 3e9, 21474836.0], f32)
    wide[SAMPLED[::7]] = np.resize(big, len(SAMPLED[::7]))
    wide[rng.choice(len(wide), 200, replace=False)] = np.resize(big, 200)
    cols["crosses_2_31"] = wide
    sub = np.round(rng.uniform(-5, 5, 2 * RG * 1024), 2).astype(f32)
    tiny = np.array([1e-44, -1e-40, 1.4e-45, 1e-39, -1.1754942e-38], f32)
    sub[rng.choice(len(sub), 300, replace=False)] = np.resize(tiny, 300)
    sub[SAMPLED[::3] + RG * 1024] = np.resize(tiny, len(SAMPLED[::3]))
    cols["subnormals"] = sub
    cols["one_value"] = np.array([0.1], f32)
    cols["n1025"] = np.round(rng.uniform(0, 10, 1025), 2).astype(f32)
    cols["two_rowgroups_tail"] = np.round(
        rng.uniform(-300, 300, 2 * RG * 1024 + 333), 3).astype(f32)
    return cols


COLUMNS = _columns()


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_blob_equals_the_reference(name):
    x = COLUMNS[name]
    want = jcontainer.compress(x).to_bytes()
    assert alp_tpu_torch.compress(x).to_bytes() == want
    assert alp_tpu_torch.compress_device(x, device="cpu").to_bytes() == want
    got = alp_tpu_torch.compress_device(values=torch.from_numpy(x),
                                        n_values=len(x), device="cpu")
    assert got.to_bytes() == want
    assert alp_tpu_torch.compress(x, device="cpu").to_bytes() == want


def test_values_as_vectors_and_from_decompress():
    x = COLUMNS["two_rowgroups_tail"]
    want = alp_tpu_torch.compress(x)
    vectors, _ = jcontainer._pad_to_vectors(x)
    got = alp_tpu_torch.compress_device(
        values=torch.from_numpy(vectors), n_values=len(x), device="cpu")
    assert got.to_bytes() == want.to_bytes()
    decoded = alp_tpu_torch.decompress(want, device="cpu")
    got = alp_tpu_torch.compress_device(values=decoded,
                                        n_values=want.n_values)
    assert got.to_bytes() == want.to_bytes()


def test_blob_equals_the_jax_device_compress():
    x = COLUMNS["encode_kernel_4"]      # 208 vectors, k > 1 in a rowgroup
    want = jdc.compress_device(x).to_bytes()
    assert alp_tpu_torch.compress_device(x, device="cpu").to_bytes() == want


def test_negative_zero_samples_follow_host_compress():
    x = COLUMNS["negative_zero_rd"]
    host = jcontainer.compress(x)
    got = alp_tpu_torch.compress_device(x, device="cpu")
    assert got.to_bytes() == host.to_bytes()
    assert (got.rg_scheme == C.SCHEME_ALP_RD).all()
    # the JAX package's device path scores -0.0 as an exception and keeps
    # ALP there: a difference of the reference package the port does not
    # copy (both of its blobs decode exactly)
    jax_device = jdc.compress_device(x)
    assert (jax_device.rg_scheme == C.SCHEME_ALP).all()
    assert jax_device.to_bytes() != host.to_bytes()


# ---------------------------------------------------------------------------
# per kernel against the JAX functions and the oracle
# ---------------------------------------------------------------------------

def _tiles(rows_u32):
    return jnp.asarray(layout.plane_to_tile(rows_u32, 32))


def _expand(per_vec):
    return jnp.asarray(layout.lane_expand(
        np.ascontiguousarray(per_vec).view(np.uint32), 32))


def _encode_inputs(rng, n=16):
    vals = np.round(rng.uniform(-1000, 1000, (n, 1024)), 2).astype(f32)
    vals[0, 5], vals[1, 7], vals[2, 9] = np.nan, np.inf, -0.0
    vals[3, 11] = 1e30                                  # impossible
    vals[4] = np.nan                                    # no non-exception
    vals[5, 10:20] = [1e-44, -1e-40, 1.4e-45, 2.2e7, -2.2e7, 2147483520.0,
                      -2147483648.0, 3e38, -3e38, 21474836.0]
    vals[6, ::2] = -0.0
    vals[7] = rng.standard_normal(1024).astype(f32) * 1e4
    e = rng.integers(0, 11, n).astype(np.int32)
    f = np.minimum(rng.integers(0, 10, n), e).astype(np.int32)
    e[:8], f[:8] = [2, 4, 1, 0, 3, 2, 1, 10], [2, 2, 0, 0, 1, 0, 1, 9]
    return vals, e, f


def test_k12_plain_equals_the_jax_encode():
    vals, e, f = _encode_inputs(np.random.default_rng(3))
    n = len(vals)
    meta = [_expand(tc.exp_arr[e]), _expand(tc.frac_arr[f]),
            _expand(tc.fact_arr[f].astype(np.int32)), _expand(tc.frac_arr[e])]
    vt = _tiles(vals.view(np.uint32))
    t = torch.from_numpy
    got = kenc.alp_encode_f32(t(vals), t(e), t(f))
    n_got, exc_got = got[0].numpy(), got[1].numpy()
    bw, base, enc_max, n_exc, fill = (
        x.numpy() for x in dc.finalize_encode_stats(got[0], *got[2:]))
    jn, jexc, stats = jencode.alp_encode_f32_tiles_stats(vt, *meta)
    jbw, jbase, jmax, jn_exc, jfill = (
        np.asarray(x)[:n] for x in jdc.finalize_encode_stats32(stats, jn))
    # n is patched at exceptions, so JAX's is compared where it is kept
    # (its interpret mode truncates the ties of some exception slots); the
    # oracle's raw encode of the replaced values is compared everywhere
    keep = ~exc_got
    assert np.array_equal(n_got[keep], layout.tile_to_values(
        np.asarray(jn), 32, np.int32, n)[keep])
    assert np.array_equal(exc_got, layout.tile_to_values(
        np.asarray(jexc), 32, np.uint32, n) != 0)
    for v in range(n):
        with np.errstate(over="ignore", invalid="ignore"):
            raw = ocore.encode_value_unsafe(
                ocore.replace_specials(vals[v], JC.FLOAT), int(f[v]),
                int(e[v]), JC.FLOAT)
        assert np.array_equal(n_got[v], raw)
    assert np.array_equal(bw, jbw) and np.array_equal(base, jbase)
    assert np.array_equal(enc_max, jmax.astype(np.int64))
    assert np.array_equal(n_exc, jn_exc)
    assert np.array_equal(fill.view(np.uint32), jfill)
    assert exc_got[2, 9] and exc_got[5, 10:13].all()     # -0.0, subnormals
    assert (bw[4], base[4], fill[4], n_exc[4]) == (0, 0, 0, 1024)
    # stats off: site 39
    jn2, jexc2 = jencode.alp_encode_f32_tiles(vt, *meta)
    n2, exc2 = kenc.alp_encode_f32(t(vals), t(e), t(f), stats=False)
    assert np.array_equal(n2.numpy(), n_got)
    assert np.array_equal(n2.numpy()[keep], layout.tile_to_values(
        np.asarray(jn2), 32, np.int32, n)[keep])
    assert np.array_equal(exc2.numpy(), layout.tile_to_values(
        np.asarray(jexc2), 32, np.uint32, n) != 0)


def test_k12_plain_equals_the_oracle_past_the_fact_table():
    vals, _, _ = _encode_inputs(np.random.default_rng(4), n=8)
    e = np.array([10, 10, 9, 0, 10, 10, 3, 10], np.int32)
    f = np.array([10, 9, 9, 0, 10, 0, 1, 10], np.int32)
    n, exc, cnt, *_ = kenc.alp_encode_f32(torch.from_numpy(vals),
                                          torch.from_numpy(e),
                                          torch.from_numpy(f))
    for v in range(len(vals)):
        with np.errstate(over="ignore", invalid="ignore"):
            enc = ocore.encode_vector(vals[v], int(f[v]), int(e[v]), JC.FLOAT)
        assert np.array_equal(np.nonzero(exc[v].numpy())[0],
                              enc.exc_positions)
        ok = ~exc[v].numpy()
        assert np.array_equal(n[v].numpy()[ok], enc.encoded[ok])
    assert exc[0].all() and int(cnt[0]) == 1024       # (10, 10) decodes NaN


@pytest.mark.parametrize("bw", [1, 15, 16, 17, 31, 32])
def test_k13_plain_equals_the_jax_pack(bw):
    rng = np.random.default_rng(bw)
    n = 8
    ints = rng.integers(-2**31, 2**31, (n, 1024), dtype=np.int64).astype(
        np.int32)
    base = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    exc = rng.random((n, 1024)) < 0.05
    fill = rng.integers(-2**20, 2**20, n).astype(np.int32)
    zeros = _expand(np.zeros(n, np.uint32))
    t = torch.from_numpy
    for patch in (True, False):
        src = np.where(exc, fill[:, None], ints) if patch else ints
        tiles = jfalp.ffor_tile(_tiles(src.view(np.uint32)), _expand(base),
                                zeros, bw=bw, element_bits=32)
        want = layout.tile_to_ref(np.asarray(tiles), bw, 32, n)
        kw = {"exc": t(exc), "fill": t(fill)} if patch else {}
        got = kffor.ffor_pack_f32(t(ints), t(base), bw, **kw)
        assert np.array_equal(got.numpy().view(np.uint32), want), patch
    # rows and offsets: a bucket written into a flat buffer
    rows = t(np.array([5, 0, 7]))
    out = torch.zeros(3 * 32 * bw + 7, dtype=torch.int32)
    offsets = t(np.array([7, 7 + 64 * bw, 7 + 32 * bw]))
    kffor.ffor_pack_f32(t(ints), t(base), bw, exc=t(exc), fill=t(fill),
                        rows=rows, out=out, offsets=offsets)
    whole = kffor.ffor_pack_f32(t(ints), t(base), bw, exc=t(exc),
                                fill=t(fill))
    for r, o in zip(rows.tolist(), offsets.tolist()):
        assert torch.equal(out[o:o + 32 * bw], whole[r])


def _samples(rng, shape):
    """Segments of float32 decimals at several scales and digit counts,
    some of random floats: no special value, no subnormal."""
    flat = np.empty((int(np.prod(shape[:-1])), shape[-1]), f32)
    for i in range(len(flat)):
        digits = int(rng.choice([0, 1, 2, 3, 5]))
        scale = rng.choice([1.0, 1e-3, 1e4, 1e-8])
        flat[i] = np.round(rng.uniform(-1000, 1000, shape[-1]),
                           digits) * scale
        if rng.random() < 0.2:
            flat[i] = rng.standard_normal(shape[-1])
    return flat.reshape(shape)


def _oracle_score(seg, e, f) -> tuple:
    """(est, non_exc) of the host search (encode_value32_safe, the decode
    compared as a float) on one segment at one pair."""
    with np.errstate(over="ignore", invalid="ignore"):
        enc = ocore.encode_value_safe(seg, f, e, JC.FLOAT)
        ok = ocore.decode_value(enc, f, e, JC.FLOAT) == seg
    mx = enc[ok].max() if ok.any() else JC.FLOAT.int_min
    mn = enc[ok].min() if ok.any() else JC.FLOAT.int_max
    return (32 * ocore.width_of_range(mx, mn, JC.FLOAT)
            + (32 - int(ok.sum())) * 48, int(ok.sum()))


# The JAX f32 scorer in interpret mode is compared at the pairs with f = 0:
# XLA's CPU backend contracts the scale's second product and the magic add
# into one FMA there, which changes the round where 10^-f is inexact (f >=
# 1), so at those pairs the host search (the oracle) is the reference.

def test_k14_first_level_equals_the_jax_scorer():
    rng = np.random.default_rng(9)
    x = _samples(rng, (3, 9, 32))
    jest, jne, jrare = jscore.first_level_scores_f32(
        jnp.asarray(x.view(np.uint32)), tc=JC.FLOAT)
    assert not np.asarray(jrare).any()
    est, ne = kscore.first_level_scores_f32(torch.from_numpy(x))
    assert est.shape == (3, 9, 66)
    es, fs = oalp.ef_pairs_arrays(tc)
    exact = fs == 0
    assert np.array_equal(est.numpy()[..., exact], np.asarray(jest)[..., exact])
    assert np.array_equal(ne.numpy()[..., exact], np.asarray(jne)[..., exact])
    for r in range(3):
        for v in range(9):
            for p, (e_, f_) in enumerate(zip(es.tolist(), fs.tolist())):
                assert (int(est[r, v, p]), int(ne[r, v, p])) == \
                    _oracle_score(x[r, v], e_, f_)


def test_k14_second_level_equals_the_jax_scorer():
    rng = np.random.default_rng(3)
    n = 40
    x = _samples(rng, (n, 32))
    e = rng.integers(0, 11, (n, 5))
    f = rng.integers(0, 11, (n, 5)) % (e + 1)
    f[::2] = 0
    combos = np.stack([e, f], -1).astype(np.int32)
    k = rng.integers(1, 6, n).astype(np.int32)
    jest, jrare = jscore.second_level_scores_f32(
        jnp.asarray(x.view(np.uint32)), jnp.asarray(combos), jnp.asarray(k),
        tc=JC.FLOAT)
    assert not np.asarray(jrare).any()
    est = kscore.second_level_scores_f32(
        torch.from_numpy(x), torch.from_numpy(combos), torch.from_numpy(k))
    live = np.arange(5)[None, :] < k[:, None]
    exact = live & (f == 0)
    assert exact.sum() > 40
    assert np.array_equal(est.numpy()[exact], np.asarray(jest)[exact])
    assert (est.numpy()[~live] == 0).all()
    for i, c in zip(*np.nonzero(live)):
        assert int(est[i, c]) == _oracle_score(x[i], int(e[i, c]),
                                               int(f[i, c]))[0]


def test_k14_search_equals_the_oracle_on_specials():
    rng = np.random.default_rng(4)
    x = np.round(rng.uniform(-100, 100, (7, 32)), 2).astype(f32)
    x[0, :5] = [np.nan, np.inf, -np.inf, -0.0, 0.0]
    x[1] = np.nan                                 # no non-exception
    x[2, :6] = [3e38, -3e38, 1e30, 2147483520.0, -2147483648.0, 2.2e7]
    x[3, :5] = [1e-44, -1e-40, 1.4e-45, 1e-39, -1.1754942e-38]
    x[4, :16] = -0.0
    x[4, 16:] = np.round(x[4, 16:])
    x[5] = -0.0
    x[6, ::3] = -21474836.0
    es, fs = oalp.ef_pairs_arrays(tc)
    est, ne = kscore.first_level_scores_f32(torch.from_numpy(x[None]))
    for s in range(len(x)):
        for p, (e_, f_) in enumerate(zip(es.tolist(), fs.tolist())):
            assert (int(est[0, s, p]), int(ne[0, s, p])) == \
                _oracle_score(x[s], e_, f_), (s, e_, f_)
    # -0.0 is a non-exception with n = INT32_MIN at f >= 1, an exception
    # at f = 0; the pair (10, 10) decodes NaN
    pair = {(e_, f_): p for p, (e_, f_) in enumerate(zip(es.tolist(),
                                                         fs.tolist()))}
    assert int(ne[0, 5, pair[(1, 1)]]) == 32
    assert int(ne[0, 5, pair[(3, 0)]]) == 0
    assert int(ne[0, 4, pair[(1, 1)]]) == 32         # n spans 32 bits
    assert int(est[0, 4, pair[(1, 1)]]) == 32 * 32
    assert int(ne[0, 4, pair[(0, 0)]]) == 16
    assert (ne[0, :, pair[(10, 10)]] == 0).all()
    assert (est[0, :, pair[(10, 10)]] == 32 + 32 * 48).all()


def test_vote_and_bit_width_on_float_sizes():
    rng = np.random.default_rng(8)
    R, V = 6, 9
    P = len(oalp.ef_pairs_arrays(tc)[0])
    worst = 32 * 48 + 32 * 32
    est = rng.choice([100, 160, 704, 1600, worst], (R, V, P)).astype(np.int32)
    ne = rng.choice([0, 1, 2, 32], (R, V, P)).astype(np.int32)
    est[0] = worst                                 # ties at worst
    ne[1] = 1                                      # nothing valid
    got = oalp.first_level_vote(torch.from_numpy(est), torch.from_numpy(ne),
                                32, tc)
    want = jalp.first_level_vote(jnp.asarray(est), jnp.asarray(ne), 32,
                                 JC.FLOAT)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    d = rng.integers(-2**31, 2**31, 500, dtype=np.int64).astype(np.int32)
    d[:3] = [0, -1, 1]
    assert np.array_equal(
        oalp.bit_width_of(torch.from_numpy(d)).numpy(),
        np.asarray(jalp.bit_width_of(jnp.asarray(d.view(np.uint32)))))
    assert int(oalp.bit_width_of(torch.tensor([-1], dtype=torch.int32))) == 32


def test_f32_wrappers_check_their_arguments():
    t = torch.from_numpy
    vals = torch.zeros((2, 1024), dtype=torch.float32)
    ok = t(np.array([3, 10], np.int32))
    kenc.alp_encode_f32(vals, ok, ok)
    for bad in (t(np.array([3, 11], np.int32)), t(np.array([-1, 0],
                                                            np.int32))):
        with pytest.raises(ValueError, match="exponents"):
            kenc.alp_encode_f32(vals, bad, ok)
    with pytest.raises(TypeError):
        kenc.alp_encode_f32(vals.double(), ok, ok)
    samples = torch.zeros((2, 32), dtype=torch.float32)
    ef = torch.zeros((2, 5, 2), dtype=torch.int32)
    ef[1, 4, 0] = 11
    with pytest.raises(ValueError, match="exponents"):
        kscore.score_pairs_f32(samples, ef)
    with pytest.raises(TypeError):
        kscore.score_pairs_f32(samples.double(), ef.clamp(max=10))
    ints = torch.zeros((2, 1024), dtype=torch.int32)
    base = torch.zeros(2, dtype=torch.int32)
    for bw in (0, 33):
        with pytest.raises(ValueError, match="bit width"):
            kffor.ffor_pack_f32(ints, base, bw)
    with pytest.raises(TypeError):
        kffor.ffor_pack_f32(ints.long(), base.long(), 3)
    with pytest.raises(TypeError):
        alp_tpu_torch.compress_device(np.ones(10, np.float16), device="cpu")
