"""Device compress of float64 columns (K9-K11 and the planner) on the CPU.

On the CPU every kernel wrapper runs its plain PyTorch version.  Held,
with no tolerance (the codec is lossless: bytes and integers are equal):

* the blob of ``compress_device`` (from a numpy array and from a tensor of
  values) equals ``alp_tpu.container.compress``'s on every f64 route
  column (two full rowgroups, so the device planner, vote and accept scan
  run), on the columns of tests/test_encode_kernel.py, on subnormals, on
  a column whose sampled values hold -0.0, NaN and +-Inf, and on 1- and
  1025-value columns; one also equals
  ``alp_tpu.device_compress.compress_device``'s (interpret mode);
* K9's plain version equals ``alp_encode_f64_tiles_stats`` +
  ``finalize_encode_stats`` and ``alp_encode_f64_tiles`` (where the TPU
  kernel flags a value "rare" and defers it to the host, the oracle's
  encode_vector, which its host fix-up runs, is the reference);
* K10's plain version equals ``ffor_planes_patch_f64`` and
  ``ffor_planes_f64`` at bit widths 1, 31, 32, 33, 52 and 64;
* K11's plain version equals ``first_level_scores_f64`` at V = 9 (the
  pairs-on-lanes branch) and V = 8 (the rows branch) and
  ``second_level_scores_f64``; on samples with specials, where the TPU
  scorer's bit-equality encode departs from the reference search, it
  equals the oracle's encode_value_safe / decode_value;
* ``first_level_vote`` and ``accept_scan`` equal ``alp_tpu.ops.alp``'s on
  estimates with ties;
* the loop steps ``make_device_compress_step`` (at ``k_max`` 1 and 5, on
  columns whose rowgroups keep one pair and three, and a mixed ALP /
  ALP_RD one) and ``make_pack_step`` at carry 0 equal
  ``alp_tpu.container.compress``'s per-vector metadata and packed words,
  ``benchlib.loop_bench(device="cpu")`` runs them, and they leave their
  inputs as they were.

``tests/test_torch_cuda.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alp_tpu import container as jcontainer
from alp_tpu import device_compress as jdc
from alp_tpu.kernels import encode as jencode
from alp_tpu.kernels import falp as jfalp
from alp_tpu.kernels import layout
from alp_tpu.kernels import score as jscore
from alp_tpu.ops import alp as jalp
from alp_tpu.oracle import core as ocore

import alp_tpu_torch
from alp_tpu_torch import benchlib
from alp_tpu_torch import constants as C
from alp_tpu_torch import device_compress as dc
from alp_tpu_torch.columns import route_columns
from alp_tpu_torch.kernels import encode as kenc
from alp_tpu_torch.kernels import ffor as kffor
from alp_tpu_torch.kernels import score as kscore
from alp_tpu_torch.ops import alp as oalp

tc = C.DOUBLE
RG = C.N_VECTORS_PER_ROWGROUP


def _columns() -> dict:
    cols = {name: x for name, x in
            route_columns(np.random.default_rng(7), 2 * RG).items()
            if x.dtype == np.float64}
    rng = np.random.default_rng(77)
    wide = np.round(rng.uniform(-100, 100, 3000), 2)     # encode :102-118
    wide[100], wide[2500] = 2.0**53, -(2.0**55)
    cols["wide_rare"] = wide
    wide2 = np.round(rng.uniform(-100, 100, 2 * RG * 1024 + 77), 2)
    wide2[rng.choice(len(wide2), 40, replace=False)] = np.tile(
        [2.0**53, -(2.0**55), 2.0**60, 3.0 * 2**70], 10)
    wide2[12 * 1024 + 64] = 2.0**53                     # a sampled value
    cols["wide_rare_2rg"] = wide2
    cols["planes_path"] = np.round(                      # encode :205-226
        np.random.default_rng(17).uniform(-900, 900, 3 * 1024 + 500), 2)
    sub = np.round(rng.uniform(-5, 5, 2 * RG * 1024), 3)
    sub[rng.choice(len(sub), 300, replace=False)] = rng.choice(
        [5e-324, -3e-310, 2.2e-308, 1e-320], 300)
    sub[::1024 * 12] = 5e-324                            # sampled values
    cols["subnormals"] = sub
    spec = np.round(rng.uniform(-50, 50, 2 * RG * 1024 + 5), 1)
    sampled = (np.arange(0, RG, 12)[:, None] * 1024
               + np.arange(0, 1024, 32)[None, :]).reshape(-1)
    for rg in range(2):
        pick = rng.choice(sampled, 12, replace=False) + rg * RG * 1024
        spec[pick] = np.tile([-0.0, np.nan, np.inf, -np.inf], 3)
    spec[rng.choice(len(spec), 50, replace=False)] = np.nan
    cols["specials_sampled"] = spec
    cols["one_value"] = np.array([0.1])
    cols["n1025"] = np.round(rng.uniform(0, 10, 1025), 2)
    cols["empty"] = np.zeros(0)
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
    x = COLUMNS["f64_specials_tail"]
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
    x = COLUMNS["f64_mixed_alp_rd"]
    want = jdc.compress_device(x).to_bytes()
    assert alp_tpu_torch.compress_device(x, device="cpu").to_bytes() == want


def test_float32_and_missing_card_raise(monkeypatch):
    """float32 compresses now (tests/test_torch_device_compress_f32.py holds
    its blobs); other dtypes raise TypeError, and so does a missing card."""
    x32 = np.ones(3000, np.float32)
    want = jcontainer.compress(x32).to_bytes()
    assert alp_tpu_torch.compress_device(x32, device="cpu").to_bytes() == want
    assert alp_tpu_torch.compress(x32, device="cpu").to_bytes() == want
    got = alp_tpu_torch.compress_device(values=torch.ones(10), device="cpu")
    assert got.to_bytes() == jcontainer.compress(np.ones(10, np.float32)
                                                 ).to_bytes()
    for bad in (np.ones(10, np.float16), np.arange(10)):
        with pytest.raises(TypeError):
            alp_tpu_torch.compress_device(bad, device="cpu")
        with pytest.raises(TypeError):
            alp_tpu_torch.compress(bad, device="cpu")
    with pytest.raises(TypeError):
        alp_tpu_torch.compress_device(values=torch.ones(10,
                                                        dtype=torch.float16),
                                      device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: alp_tpu_torch.compress_device(np.ones(10)),
                 lambda: alp_tpu_torch.compress(np.ones(10), device=True),
                 lambda: alp_tpu_torch.compress(np.ones(10), "cuda:1")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError):
        alp_tpu_torch.compress_device(np.ones(10), values=torch.ones(10))


# ---------------------------------------------------------------------------
# per kernel against the JAX functions
# ---------------------------------------------------------------------------

def _u32(u):
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _tiles(rows_u64):
    hi, lo = _u32(rows_u64)
    return (jnp.asarray(layout.plane_to_tile(hi, 64)),
            jnp.asarray(layout.plane_to_tile(lo, 64)))


def _rows(plane, n):
    """[G, 64, 128] tile plane -> [n, 1024] in value order."""
    p = np.asarray(plane)
    G = p.shape[0]
    return p.reshape(G, 64, 8, 16).transpose(0, 2, 1, 3).reshape(-1, 1024)[:n]


def _expand(per_vec):
    hi, lo = _u32(np.ascontiguousarray(per_vec).view(np.uint64))
    return (jnp.asarray(layout.lane_expand(lo, 64)),
            jnp.asarray(layout.lane_expand(hi, 64)))


def _encode_inputs(rng, n=16):
    vals = np.round(rng.uniform(-500, 500, (n, 1024)), 2)
    vals[1] = rng.standard_normal(1024) * 1e6
    vals[2, :6] = [np.nan, -np.inf, np.inf, -0.0, 0.0, 1e308]
    vals[3] = np.nan                                   # no non-exception
    vals[4, 10:20] = [5e-324, -1e-310, 2.0**53, -(2.0**55), 2.0**60,
                      1e18, -1e17, 9.2e18, -9.3e18, 2.0**-1074]
    vals[5, ::2] = -0.0
    e = rng.integers(0, 19, n).astype(np.int32)
    f = np.minimum(rng.integers(0, 19, n), e).astype(np.int32)
    e[:4], f[:4] = [14, 14, 0, 3], [12, 10, 0, 1]
    return vals, e, f


def test_k9_plain_equals_the_jax_encode():
    vals, e, f = _encode_inputs(np.random.default_rng(5))
    n = len(vals)
    meta = [*_expand(tc.exp_arr[e]), *_expand(tc.frac_arr[f]),
            *_expand(tc.fact_arr[f]), *_expand(tc.frac_arr[e])]
    vhi, vlo = _tiles(vals.view(np.uint64))
    got = kenc.alp_encode_f64(torch.from_numpy(vals), torch.from_numpy(e),
                              torch.from_numpy(f))
    n_got, exc_got = got[0].numpy(), got[1].numpy()
    bw, base, enc_max, n_exc, fill = (
        x.numpy() for x in dc.finalize_encode_stats(got[0], *got[2:]))
    nhi, nlo, jexc, stats = jencode.alp_encode_f64_tiles_stats(vhi, vlo,
                                                               *meta)
    jn = ((_rows(nhi, n).astype(np.uint64) << np.uint64(32))
          | _rows(nlo, n)).view(np.int64)
    jexc = _rows(jexc, n) != 0
    jbw, jbase, jmax, jn_exc, jrare, flo, fhi = (
        np.asarray(x)[:n] for x in jdc.finalize_encode_stats(stats, nhi,
                                                             nlo))
    jfill = ((fhi.astype(np.uint64) << np.uint64(32)) | flo).view(np.int64)
    special = ~np.isfinite(vals) | (vals.view(np.uint64) == np.uint64(1 << 63))
    _, _, rare_plane, _ = jencode.alp_encode_f64_tiles(vhi, vlo, *meta)
    rare = _rows(rare_plane, n) != 0
    # n is a don't-care at specials (always exceptions, patched)
    keep = ~rare & ~special
    assert np.array_equal(n_got[keep], jn[keep])
    assert np.array_equal(exc_got[~rare], jexc[~rare])
    ok = ~jrare
    for got_x, want_x in ((bw, jbw), (base, jbase), (enc_max, jmax),
                          (n_exc, jn_exc), (fill, jfill)):
        assert np.array_equal(got_x[ok], want_x[ok])
    # rare vectors: the oracle's encode, which the JAX host fix-up runs
    for v in np.nonzero(jrare)[0]:
        enc = ocore.encode_vector(vals[v], int(f[v]), int(e[v]), tc)
        obw, obase = ocore.analyze_ffor(enc.encoded, tc)
        assert (bw[v], base[v], n_exc[v]) == (obw, obase,
                                              len(enc.exc_positions))
        assert np.array_equal(np.nonzero(exc_got[v])[0], enc.exc_positions)
    assert jrare.any() and (bw[3], base[3], fill[3], n_exc[3]) == (0, 0, 0,
                                                                   1024)
    # stats off: site 41
    jhi, jlo, jexc2, _ = jencode.alp_encode_f64_tiles(vhi, vlo, *meta)
    n2, exc2 = kenc.alp_encode_f64(torch.from_numpy(vals),
                                   torch.from_numpy(e), torch.from_numpy(f),
                                   stats=False)
    jn2 = ((_rows(jhi, n).astype(np.uint64) << np.uint64(32))
           | _rows(jlo, n)).view(np.int64)
    assert np.array_equal(n2.numpy()[keep], jn2[keep])
    assert np.array_equal(exc2.numpy()[~rare], (_rows(jexc2, n) != 0)[~rare])


@pytest.mark.parametrize("bw", [1, 31, 32, 33, 52, 64])
def test_k10_plain_equals_the_jax_pack(bw):
    rng = np.random.default_rng(bw)
    n = 8
    ints = rng.integers(-2**63, 2**63, (n, 1024), dtype=np.int64,
                        endpoint=False)
    base = rng.integers(-2**63, 2**63, n, dtype=np.int64)
    exc = rng.random((n, 1024)) < 0.05
    fill = rng.integers(-2**40, 2**40, n, dtype=np.int64)
    nhi, nlo = _tiles(ints.view(np.uint64))
    blo, bhi = _expand(base)
    flo, fhi = _expand(fill)
    ehi = jnp.asarray(layout.plane_to_tile(exc.astype(np.uint32), 64))
    t = torch.from_numpy
    for patch in (True, False):
        if patch:
            tiles = jfalp.ffor_planes_patch_f64(nhi, nlo, ehi, flo, fhi, blo,
                                                bhi, bw=bw)
            got = kffor.ffor_pack_f64(t(ints), t(base), bw, exc=t(exc),
                                      fill=t(fill))
        else:
            tiles = jfalp.ffor_planes_f64(nhi, nlo, blo, bhi, bw=bw)
            got = kffor.ffor_pack_f64(t(ints), t(base), bw)
        want = layout.tile_to_ref(np.asarray(tiles), bw, 64, n)
        assert np.array_equal(got.numpy().view(np.uint64), want), patch
    # rows and offsets: a bucket written into a flat buffer
    rows = t(np.array([5, 0, 7]))
    out = torch.zeros(3 * 16 * bw + 7, dtype=torch.int64)
    offsets = t(np.array([7, 7 + 32 * bw, 7 + 16 * bw]))
    kffor.ffor_pack_f64(t(ints), t(base), bw, exc=t(exc), fill=t(fill),
                        rows=rows, out=out, offsets=offsets)
    whole = kffor.ffor_pack_f64(t(ints), t(base), bw, exc=t(exc),
                                fill=t(fill))
    for r, o in zip(rows.tolist(), offsets.tolist()):
        assert torch.equal(out[o:o + 16 * bw], whole[r])


def _samples(rng, shape):
    """Segments of decimals at several scales and digit counts, some of
    random doubles: no special value, no subnormal."""
    flat = np.empty((int(np.prod(shape[:-1])), shape[-1]))
    for i in range(len(flat)):
        digits = int(rng.choice([0, 1, 2, 4, 8]))
        scale = rng.choice([1.0, 1e-3, 1e6, 1e-12])
        flat[i] = np.round(rng.uniform(-1000, 1000, shape[-1]),
                           digits) * scale
        if rng.random() < 0.2:
            flat[i] = rng.standard_normal(shape[-1])
    return flat.reshape(shape)


@pytest.mark.parametrize("V", [9, 8])
def test_k11_first_level_equals_the_jax_scorer(V):
    rng = np.random.default_rng(V)
    x = _samples(rng, (2, V, 32))
    hi, lo = _u32(x.view(np.uint64))
    jest, jne, jrare = jscore.first_level_scores_f64(
        jnp.asarray(hi), jnp.asarray(lo), tc=tc)
    assert not np.asarray(jrare).any()
    est, ne = kscore.first_level_scores_f64(torch.from_numpy(x))
    assert np.array_equal(est.numpy(), np.asarray(jest))
    assert np.array_equal(ne.numpy(), np.asarray(jne))


def test_k11_second_level_equals_the_jax_scorer():
    rng = np.random.default_rng(3)
    n = 40
    x = _samples(rng, (n, 32))
    e = rng.integers(0, 19, (n, 5))
    combos = np.stack([e, rng.integers(0, 19, (n, 5)) % (e + 1)],
                      -1).astype(np.int32)
    k = rng.integers(1, 6, n).astype(np.int32)
    hi, lo = _u32(x.view(np.uint64))
    jest, jrare = jscore.second_level_scores_f64(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(combos),
        jnp.asarray(k), tc=tc)
    assert not np.asarray(jrare).any()
    est = kscore.second_level_scores_f64(
        torch.from_numpy(x), torch.from_numpy(combos), torch.from_numpy(k))
    live = np.arange(5)[None, :] < k[:, None]
    assert np.array_equal(est.numpy()[live], np.asarray(jest)[live])
    assert (est.numpy()[~live] == 0).all()


def test_k11_search_equals_the_oracle_on_specials():
    rng = np.random.default_rng(4)
    x = np.round(rng.uniform(-100, 100, (6, 32)), 2)
    x[0, :5] = [np.nan, np.inf, -np.inf, -0.0, 0.0]
    x[1] = np.nan                                 # no non-exception
    x[2, :4] = [-(2.0**63), 2.0**63, 1e300, -1e-300]
    x[3, :3] = [5e-324, -2.2e-308, 1e-310]
    x[4, :2] = [9.223372036854774784e18, -9.223372036854774784e18]
    es, fs = oalp.ef_pairs_arrays(tc)
    est, ne = kscore.first_level_scores_f64(torch.from_numpy(x[None]))
    for s in range(len(x)):
        for p, (e_, f_) in enumerate(zip(es.tolist(), fs.tolist())):
            with np.errstate(over="ignore", invalid="ignore"):
                enc = ocore.encode_value_safe(x[s], f_, e_, tc)
            ok = ocore.decode_value(enc, f_, e_, tc) == x[s]
            mx = enc[ok].max() if ok.any() else tc.int_min
            mn = enc[ok].min() if ok.any() else tc.int_max
            want = (32 * ocore.width_of_range(mx, mn, tc)
                    + (32 - int(ok.sum())) * 80)
            assert (int(est[0, s, p]), int(ne[0, s, p])) == (want,
                                                             int(ok.sum()))


def test_vote_and_scan_equal_the_jax_ops():
    rng = np.random.default_rng(8)
    R, V = 6, 9
    P = len(oalp.ef_pairs_arrays(tc)[0])
    est = rng.choice([100, 160, 200, 1600, 4608], (R, V, P)).astype(np.int32)
    ne = rng.choice([0, 1, 2, 32], (R, V, P)).astype(np.int32)
    est[0] = 4608                                  # ties at worst
    ne[1] = 1                                      # nothing valid
    got = oalp.first_level_vote(torch.from_numpy(est), torch.from_numpy(ne),
                                32, tc)
    want = jalp.first_level_vote(jnp.asarray(est), jnp.asarray(ne), 32, tc)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    n = 200
    est2 = rng.choice([5, 7, 9], (n, 5)).astype(np.int32)
    combos = rng.integers(0, 19, (n, 5, 2)).astype(np.int32)
    k = rng.integers(0, 6, n).astype(np.int32)
    got = oalp.accept_scan(torch.from_numpy(est2), torch.from_numpy(combos),
                           torch.from_numpy(k))
    want = jalp.accept_scan(jnp.asarray(est2), jnp.asarray(combos),
                            jnp.asarray(k))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    d = rng.integers(-2**63, 2**63, 500, dtype=np.int64)
    d[:3] = [0, -1, 1]
    assert np.array_equal(
        oalp.bit_width_of(torch.from_numpy(d)).numpy(),
        np.asarray(jalp.bit_width_of(jnp.asarray(d.view(np.uint64)))))


def test_wrappers_check_their_arguments():
    t = torch.from_numpy
    vals = torch.zeros((2, 1024), dtype=torch.float64)
    ok = t(np.array([3, 18], np.int32))
    kenc.alp_encode_f64(vals, ok, ok)
    for bad in (t(np.array([3, 19], np.int32)), t(np.array([-1, 0],
                                                            np.int32))):
        with pytest.raises(ValueError, match="exponents"):
            kenc.alp_encode_f64(vals, bad, ok)
        with pytest.raises(ValueError, match="exponents"):
            kenc.alp_encode_f64(vals, ok, bad)
    with pytest.raises(TypeError):
        kenc.alp_encode_f64(vals, ok.long(), ok)
    samples = torch.zeros((2, 32), dtype=torch.float64)
    ef = torch.zeros((2, 5, 2), dtype=torch.int32)
    ef[1, 4, 0] = 19
    with pytest.raises(ValueError, match="exponents"):
        kscore.score_pairs_f64(samples, ef)
    with pytest.raises(ValueError):
        kscore.score_pairs_f64(samples, ef[:, :, :1].contiguous())
    ints = torch.zeros((2, 1024), dtype=torch.int64)
    base = torch.zeros(2, dtype=torch.int64)
    for bw in (0, 65):
        with pytest.raises(ValueError, match="bit width"):
            kffor.ffor_pack_f64(ints, base, bw)
    with pytest.raises(ValueError, match="rows"):
        kffor.ffor_pack_f64(ints, base, 3, rows=t(np.array([0, 2])))
    with pytest.raises(ValueError, match="offsets"):
        kffor.ffor_pack_f64(ints, base, 3, out=torch.zeros(60,
                                                           dtype=torch.int64),
                            offsets=t(np.array([0, 48])))
    with pytest.raises(ValueError, match="together"):
        kffor.ffor_pack_f64(ints, base, 3, exc=torch.zeros((2, 1024),
                                                           dtype=torch.bool))


# ---------------------------------------------------------------------------
# the loop steps make_device_compress_step and make_pack_step
# ---------------------------------------------------------------------------

def _step_columns() -> dict:
    rng = np.random.default_rng(21)
    n = 3 * RG * 1024
    one = np.round(rng.uniform(-20, 180, n), 1)
    # the sampled vectors (every 12th) take three precisions in turn, so
    # every rowgroup keeps three pairs
    multi = np.round(rng.uniform(0, 100, n), 2)
    turn = np.arange(n) // 1024 // 12 % 3
    multi[turn == 1] = np.round(rng.uniform(0, 100, int((turn == 1).sum())),
                                4)
    multi[turn == 2] = np.round(rng.uniform(0, 1e4, int((turn == 2).sum())),
                                1)
    return {"k1": one, "k_multi": multi,
            "mixed_alp_rd": COLUMNS["f64_mixed_alp_rd"]}


STEP_COLUMNS = _step_columns()
ZERO = torch.zeros((), dtype=torch.int64)


def _kept_pairs(x) -> np.ndarray:
    return alp_tpu_torch.container.plan_rowgroups(x.reshape(-1, 1024),
                                                  tc)[2]


def test_step_columns_keep_the_pairs_they_are_for():
    assert (_kept_pairs(STEP_COLUMNS["k1"]) == 1).all()
    assert (_kept_pairs(STEP_COLUMNS["k_multi"]) > 1).all()


@pytest.mark.parametrize("name,k_max", [("k1", 1), ("k1", 5),
                                        ("k_multi", 5), ("mixed_alp_rd", 5)])
def test_device_compress_step_equals_the_reference(name, k_max):
    x = STEP_COLUMNS[name]
    want = jcontainer.compress(x)
    values = torch.from_numpy(x.reshape(-1, 1024).copy())
    step, args = dc.make_device_compress_step(values, k_max)
    meta = step.result(ZERO, *args)
    for field in ("fac", "exp", "bit_width", "base"):
        assert np.array_equal(getattr(meta, field).numpy(),
                              getattr(want, field).astype(np.int64)), field
    assert np.array_equal(meta.enc_max.numpy().view(np.uint64), want.enc_max)
    # an ALP_RD vector's exceptions come from its dictionary, which the
    # step leaves out: it counts ALP exceptions alone
    alp = want.rg_scheme[np.arange(want.n_vectors) // RG] == C.SCHEME_ALP
    assert np.array_equal(meta.exc_count.numpy()[alp], want.exc_count[alp])
    assert not meta.exc_count.numpy()[~alp].any()
    assert benchlib.loop_bench(step, args, 2, device="cpu") > 0
    assert np.array_equal(values.numpy().reshape(-1), x)   # left as it was


def test_device_compress_step_at_k_max_1_takes_the_first_pair():
    x = STEP_COLUMNS["k_multi"]
    combos = alp_tpu_torch.container.plan_rowgroups(x.reshape(-1, 1024),
                                                    tc)[1]
    values = torch.from_numpy(x.reshape(-1, 1024).copy())
    meta = dc.make_device_compress_step(values, 1)[0].result(ZERO, values)
    first = combos[np.arange(values.shape[0]) // RG, 0]
    assert np.array_equal(meta.exp.numpy(), first[:, 0])
    assert np.array_equal(meta.fac.numpy(), first[:, 1])
    assert not np.array_equal(meta.fac.numpy(),
                              jcontainer.compress(x).fac.astype(np.int32))


@pytest.mark.parametrize("name", ["k1", "k_multi"])
def test_pack_step_equals_the_reference(name):
    x = STEP_COLUMNS[name]
    want = np.concatenate(jcontainer.compress(x).packed)
    col = alp_tpu_torch.compress(x)
    values = torch.from_numpy(x.reshape(-1, 1024).copy())
    step, args = dc.make_pack_step(col, values)
    assert np.array_equal(step.result(ZERO, *args).numpy().view(np.uint64),
                          want)
    assert benchlib.loop_bench(step, args, 2, device="cpu") > 0
    assert np.array_equal(step.result(ZERO, *args).numpy().view(np.uint64),
                          want)


def test_steps_refuse_what_they_cannot_take():
    x = STEP_COLUMNS["k1"]
    values = torch.from_numpy(x.reshape(-1, 1024).copy())
    with pytest.raises(TypeError):
        dc.make_device_compress_step(values.float())
    with pytest.raises(ValueError):
        dc.make_device_compress_step(values.reshape(-1))
    for k_max in (0, 6):
        with pytest.raises(ValueError):
            dc.make_device_compress_step(values, k_max)
    col = alp_tpu_torch.compress(x)
    with pytest.raises(ValueError, match="vectors"):
        dc.make_pack_step(col, values[:100].contiguous())
    with pytest.raises(ValueError, match="encode"):
        dc.make_pack_step(col, (values + 0.5).contiguous())
    mixed = STEP_COLUMNS["mixed_alp_rd"]
    with pytest.raises(ValueError, match="ALP rowgroups"):
        dc.make_pack_step(alp_tpu_torch.compress(mixed), torch.from_numpy(
            mixed.reshape(-1, 1024).copy()))
