"""The port's bench: K20-K23 against the TPU sites, the loop steps, the
headline.

On the CPU each kernel's wrapper runs its plain PyTorch version; here the
plain versions are held against the Pallas kernels they replace, run as
the JAX package's own tests run them (interpret mode), at most 4 groups
(32 f64 or 16 f32 vectors) a call:

* K20 ``variant_sum_f64`` against site 20 ``falp_decode_f64_variant_sum``
  on every bucket of the four variants it takes (small, mid, mid64,
  midc96, the wide two also all negative) and of two route columns,
  mapped through ``_Group.vec_indices``: the truncated float terms (the
  JAX decode through ``_f64_bits_to_f32``) equal by bits, and each lane's
  float sum within ``64 * 2^-24 * sum |term|`` of the reference's, whose
  XLA reduction adds in another order;
* K21 ``rd_glue_f64/_f32`` against sites 10 and 11 ``rd_decode_f64/_f32``
  on the right parts and resolved left parts of real ALP_RD columns and on
  random bits at rbw 48, 52, 60 (f64) and 16, 24, 0 (f32); tolerance 0;
* K22 ``unffor`` against site 12 ``unffor_tile`` at bw 0, 1, 16, 52, 64
  (64-bit elements) and 0, 7, 30, 32 (32-bit); tolerance 0;
* K23 ``key_extremes_bits_f64`` against site 32
  ``key_extremes_planes_f64``, its per-lane-column rows reduced over each
  vector's 16 columns, on every f64 route column and one of NaN of both
  signs, +-Inf, +-0.0 and subnormals; tolerance 0.

Then the six loop steps of ``engine`` at carry 0 against the port's
queries (and K20's sums against a numpy mirror of its truncating sum),
``benchlib.loop_bench`` on the CPU, and ``python -m alp_tpu_torch.bench``
at 2 rowgroups on the CPU and without a card.
"""

import contextlib
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from alp_tpu import container as jcontainer
from alp_tpu.kernels import decode as jdecode
from alp_tpu.kernels import falp as jfalp
from alp_tpu.kernels import layout

import alp_tpu_torch
from alp_tpu_torch import (bench, bench_speed, benchlib, columns, engine,
                           interop)
from alp_tpu_torch import constants as C
from alp_tpu_torch.kernels import decode
from alp_tpu_torch.kernels import falp as kfalp
from alp_tpu_torch.kernels import ffor as kffor
from alp_tpu_torch.kernels import group as kgroup
from alp_tpu_torch.ops.fastlanes import words_from_numpy
from test_torch_falp import K1_CASES, _alp_column, _fields
from test_torch_query import NAMES, _columns

CPU = {"device": "cpu"}
CHUNK = 4                          # JAX groups a call in interpret mode
SITE20 = ("small", "mid", "mid64", "mid64_allneg", "midc96",
          "midc96_allneg")
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _u(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(f"u{a.itemsize}")


def _chunks(n_groups: int):
    return [slice(j, min(j + CHUNK, n_groups))
            for j in range(0, n_groups, CHUNK)]


def _to_values(planes: np.ndarray, S: int) -> np.ndarray:
    """[G, S, 128] planes (row = slot, column = vector in group * L +
    lane) -> [G * 128 / L, 1024] values in value order."""
    L = 1024 // S
    G = planes.shape[0]
    return planes.reshape(G, S, 128 // L, L).transpose(0, 2, 1, 3).reshape(
        -1, 1024)


def _padded(a: np.ndarray, group: int) -> np.ndarray:
    pad = (-a.shape[0]) % group
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


# ---------------------------------------------------------------------------
# K20 against site 20
# ---------------------------------------------------------------------------

def _trunc_f32_numpy(bits: np.ndarray) -> np.ndarray:
    """A numpy mirror of the reference's truncating convert."""
    hi = (bits >> np.uint64(32)).astype(np.uint32)
    lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    e = ((hi >> np.uint32(20)) & np.uint32(0x7FF)).astype(np.int64)
    e32 = np.clip(e - 896, 0, 254).astype(np.uint32)
    m = ((hi & np.uint32(0xFFFFF)) << np.uint32(3)) | (lo >> np.uint32(29))
    return ((hi & np.uint32(0x80000000)) | (e32 << np.uint32(23)) | m).view(
        np.float32)


def _lane_sums_numpy(bits: np.ndarray) -> np.ndarray:
    """[n, 1024] u64 -> [n, 16] float32 sums in slot order."""
    terms = _trunc_f32_numpy(bits).reshape(-1, 64, 16)
    acc = np.zeros((terms.shape[0], 16), np.float32)
    for s in range(64):
        acc = acc + terms[:, s]
    return acc


def _k20_port(col):
    """(K20's plain [n_vectors, 16] sums, its float terms [n_vectors,
    1024]) over the ALP buckets of a port column."""
    plan = decode.build_plan(col, "cpu")
    sums = np.zeros((col.n_vectors, 16), np.float32)
    terms = np.zeros((col.n_vectors, 1024), np.float32)
    for b in plan.buckets:
        if b.scheme != C.SCHEME_ALP:
            continue
        sums[b.rows.numpy()] = kfalp.variant_sum_f64(
            b.args[0], b.bw, *b.args[1:]).numpy()
        vals = kfalp.falp_plain(b.args[0], b.bw, *b.args[1:])
        terms[b.rows.numpy()] = kfalp.trunc_f32_plain(
            vals.view(torch.int64)).numpy()
    return sums, terms


def _check_site20(jcol, col) -> set:
    sums, terms = _k20_port(col)
    seen = set()
    for g in jdecode.build_plan(jcol).groups:
        if g.scheme != C.SCHEME_ALP or g.variant not in (
                "small", "mid", "mid64", "midc96"):
            continue
        args = jdecode.group_arrays(g)
        for sl in _chunks(args[0].shape[0]):
            part = [a[sl] for a in args]
            got = np.asarray(jfalp.falp_decode_f64_variant_sum(
                part[0], tuple(part[1:]), variant=g.variant, bw=g.bw,
                flags=g.flags))
            hi, lo = jdecode.group_decode(g, np.float64)(*part)
            jterms = np.asarray(jfalp._f64_bits_to_f32(hi, lo))
            for j in range(got.shape[0]):
                for m in range(8):
                    i = (sl.start + j) * 8 + m
                    if i >= g.n_vectors:
                        continue
                    v = g.vec_indices[i]
                    mine = terms[v].reshape(64, 16)
                    theirs = jterms[j, :, m * 16:(m + 1) * 16]
                    assert np.array_equal(mine.view(np.uint32),
                                          theirs.view(np.uint32)), v
                    tol = 64 * 2.0**-24 * np.abs(
                        mine.astype(np.float64)).sum(axis=0)
                    diff = np.abs(sums[v].astype(np.float64)
                                  - got[j, m * 16:(m + 1) * 16])
                    assert np.all(diff <= tol), (v, diff, tol)
            seen.add(g.variant)
    return seen


@pytest.mark.parametrize("case", SITE20)
def test_k20_plain_equals_site_20(case):
    make, fac, exp, variant = K1_CASES[case]
    ints = make(np.random.default_rng(len(case))).astype(np.int64)
    jcol = _alp_column(ints, fac, exp)
    col = interop.column_from_arrays(_fields(jcol))
    assert variant in _check_site20(jcol, col)


@pytest.mark.parametrize("name", ["bw_33_52", "specials"])
def test_k20_plain_equals_site_20_on_route_columns(name):
    """Compressed columns: a tail (the pad summed as decoded) and
    exceptions (their slots summed unpatched, as site 20 does)."""
    _, jcol, col = _columns(name)
    assert _check_site20(jcol, col)


def test_k20_plain_equals_numpy_mirror():
    x, _, col = _columns("specials")
    plan = decode.build_plan(col, "cpu")
    for b in plan.buckets:
        got = kfalp.variant_sum_f64(b.args[0], b.bw, *b.args[1:]).numpy()
        bits = _u(kfalp.falp_plain(b.args[0], b.bw, *b.args[1:]))
        assert np.array_equal(got.view(np.uint32),
                              _lane_sums_numpy(bits).view(np.uint32))


def test_trunc_convert_of_specials():
    """+-Inf and NaN come out finite (exponent clamped at 254), a value
    below float's range as a flushed exponent with the cut mantissa."""
    vals = np.array([np.inf, -np.inf, np.nan, 1.0, -2.5, 1e-300, 0.1,
                     -0.0, 3.4e38, 1e39], np.float64)
    bits = vals.view(np.uint64)
    got = kfalp.trunc_f32_plain(torch.from_numpy(bits.view(np.int64)))
    want = np.asarray(jfalp._f64_bits_to_f32(
        (bits >> np.uint64(32)).astype(np.uint32),
        (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert np.isfinite(got.numpy()[:3]).all()


# ---------------------------------------------------------------------------
# K21 against sites 10 and 11
# ---------------------------------------------------------------------------

def _site_rd(right: np.ndarray, rbw: int, left: np.ndarray,
             S: int) -> np.ndarray:
    """rd_decode_f64 / _f32 on [n, rbw * L] words and [n, 1024] u32 left
    parts, chunked, back in value order."""
    L, group, _ = layout.geometry(S)
    n = right.shape[0]
    tiles = layout.ref_to_tile(_padded(right, group), rbw, S)
    lt = layout.plane_to_tile(_padded(left, group), S)
    out = []
    for sl in _chunks(tiles.shape[0]):
        if S == 64:
            hi, lo = jfalp.rd_decode_f64(tiles[sl], lt[sl], rbw=rbw)
            u = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
                 | np.asarray(lo).astype(np.uint64))
        else:
            u = np.asarray(jfalp.rd_decode_f32(tiles[sl], lt[sl], rbw=rbw))
        out.append(_to_values(u, S))
    return np.concatenate(out)[:n]


def _glue(right: np.ndarray, rbw: int, left: np.ndarray) -> np.ndarray:
    fn = kfalp.rd_glue_f64 if right.dtype == np.uint64 else \
        kfalp.rd_glue_f32
    return _u(fn(words_from_numpy(right), rbw, words_from_numpy(left)))


@pytest.mark.parametrize("name", ["f64_rd", "f32_rd", "mixed_alp_rd"])
def test_k21_plain_equals_sites_10_11_on_rd_columns(name):
    """The right parts of every ALP_RD bucket and the left parts of the
    full decode (dictionary resolved, exceptions patched): the glue gives
    the decode back, and equals the TPU kernel."""
    _, _, col = _columns(name)
    plan = decode.build_plan(col, "cpu")
    bits = _u(plan.run())
    S = 8 * bits.itemsize
    rd = [b for b in plan.buckets if b.scheme == C.SCHEME_ALP_RD]
    assert rd
    for b in rd:
        want = bits[b.rows.numpy()]
        left = (want >> want.dtype.type(b.bw)).astype(np.uint32)
        right = _u(b.args[0])
        got = _glue(right, b.bw, left)
        assert np.array_equal(got, want)
        assert np.array_equal(got, _site_rd(right, b.bw, left, S))


@pytest.mark.parametrize("S,rbw", [(64, 48), (64, 52), (64, 60), (32, 16),
                                   (32, 24), (32, 0)])
def test_k21_plain_equals_sites_10_11_on_random_bits(S, rbw):
    rng = np.random.default_rng(S + rbw)
    ut = np.uint64 if S == 64 else np.uint32
    n = 20                                      # a partial JAX group
    right = rng.integers(0, 2**63, (n, rbw * (1024 // S)),
                         dtype=np.uint64).astype(ut)
    left = rng.integers(0, 2**32, (n, 1024), dtype=np.uint64).astype(
        np.uint32)
    got = _glue(right, rbw, left)
    assert np.array_equal(got, _site_rd(right, rbw, left, S))


def test_k21_refuses_what_the_reference_cannot_glue():
    right = torch.zeros((1, 16 * 47), dtype=torch.int64)
    left = torch.zeros((1, 1024), dtype=torch.int32)
    with pytest.raises(ValueError, match="48..64"):
        kfalp.rd_glue_f64(right, 47, left)
    with pytest.raises(TypeError):
        kfalp.rd_glue_f32(right, 47, left)


# ---------------------------------------------------------------------------
# K22 against site 12
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,bw", [(64, 0), (64, 1), (64, 16), (64, 52),
                                  (64, 64), (32, 0), (32, 7), (32, 30),
                                  (32, 32)])
def test_k22_plain_equals_site_12(S, bw):
    rng = np.random.default_rng(S * 100 + bw)
    ut = np.uint64 if S == 64 else np.uint32
    L, group, _ = layout.geometry(S)
    n = 2 * group + 3
    packed = rng.integers(0, 2**63, (n, bw * L), dtype=np.uint64).astype(ut)
    base = rng.integers(0, 2**63, n, dtype=np.uint64).astype(ut)
    got = _u(kffor.unffor(words_from_numpy(packed), bw,
                          words_from_numpy(base)))
    tiles = layout.ref_to_tile(_padded(packed, group), bw, S)
    b64 = _padded(base, group).astype(np.uint64)
    blo = layout.lane_expand((b64 & np.uint64(0xFFFFFFFF)).astype(
        np.uint32), S)
    bhi = layout.lane_expand((b64 >> np.uint64(32)).astype(np.uint32), S)
    out = []
    for sl in _chunks(tiles.shape[0]):
        res = jfalp.unffor_tile(tiles[sl], blo[sl], bhi[sl], bw=bw,
                                element_bits=S)
        if S == 64:
            u = ((np.asarray(res[0]).astype(np.uint64) << np.uint64(32))
                 | np.asarray(res[1]).astype(np.uint64))
        else:
            u = np.asarray(res)
        out.append(_to_values(u, S))
    assert np.array_equal(got, np.concatenate(out)[:n])


# ---------------------------------------------------------------------------
# K23 against site 32
# ---------------------------------------------------------------------------

def _site32_per_vector(bits: np.ndarray) -> np.ndarray:
    """Site 32 on the planes of ``bits`` [n, 1024] u64, its rows (least
    and largest biased i32 key words of each lane column) reduced over the
    16 lane columns of each vector: [n, 2] unsigned keys."""
    n = bits.shape[0]
    planes = layout.plane_to_tile(_padded(bits, 8), 64)
    rows = []
    for sl in _chunks(planes.shape[0]):
        p = planes[sl]
        rows.append(np.asarray(jfalp.key_extremes_planes_f64(
            (p >> np.uint64(32)).astype(np.uint32),
            (p & np.uint64(0xFFFFFFFF)).astype(np.uint32))))
    r = np.concatenate(rows)[:, :4].reshape(-1, 4, 8, 16)
    words = (r.transpose(0, 2, 1, 3).reshape(-1, 4, 16).astype(np.int64)
             & 0xFFFFFFFF) ^ (1 << 31)       # biased i32 -> key words
    out = np.zeros((n, 2), np.uint64)
    for v in range(n):
        least = min(zip(words[v, 0].tolist(), words[v, 1].tolist()))
        largest = max(zip(words[v, 2].tolist(), words[v, 3].tolist()))
        out[v] = ((least[0] << 32) | least[1], (largest[0] << 32) | largest[1])
    return out


def _specials_bits() -> np.ndarray:
    rng = np.random.default_rng(32)
    x = rng.standard_normal(5 * 1024) * 10.0 ** rng.integers(-300, 300,
                                                             5 * 1024)
    x[::7] = np.nan
    x[1::11] = -np.nan
    x[2::13] = np.inf
    x[3::17] = -np.inf
    x[4::19] = 0.0
    x[5::23] = -0.0
    x[6::29] = 5e-324 * rng.integers(1, 2**40, len(x[6::29]))   # subnormal
    x[7::31] = -5e-324 * rng.integers(1, 2**40, len(x[7::31]))
    x[:1024] = -0.0                          # a vector of -0.0 alone
    x[1024:1030] = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf]
    return x.view(np.uint64).reshape(-1, 1024)


@pytest.mark.parametrize("name", [n for n in NAMES if n not in
                                  ("f32_alp", "f32_rd")] + ["specials_bits"])
def test_k23_plain_equals_site_32(name):
    if name == "specials_bits":
        bits = _specials_bits()
    else:
        _, _, col = _columns(name)
        bits = _u(decode.build_plan(col, "cpu").run())
    got = _u(kgroup.key_extremes_bits_f64(words_from_numpy(bits)))
    assert np.array_equal(got, _site32_per_vector(bits))


# ---------------------------------------------------------------------------
# The loop steps at carry 0
# ---------------------------------------------------------------------------

ZERO = torch.zeros((), dtype=torch.int64)
STEP_NAMES = ["bw_le32", "f32_alp", "mixed_alp_rd", "specials"]


def _zeros_column():
    """An f64 column of zeros: one ALP bucket of bit width 0."""
    jcol = jcontainer.compress(np.zeros(3000))
    return np.zeros(3000), alp_tpu_torch.CompressedColumn.from_bytes(
        jcol.to_bytes())


@pytest.mark.parametrize("name", STEP_NAMES + ["zeros"])
def test_sum_step_partials_equal_numpy_mirror(name):
    if name == "zeros":
        _, col = _zeros_column()
    else:
        _, _, col = _columns(name)
    plan = col.plan("cpu")
    step, args = engine.make_sum_step(plan)
    parts = step.result(ZERO, *args)
    assert len(parts) == len(plan.buckets)
    for b, part in zip(plan.buckets, parts):
        if plan.f64 and b.scheme == C.SCHEME_ALP and b.bw > 0:
            bits = _u(kfalp.falp_plain(b.args[0], b.bw, *b.args[1:]))
            assert np.array_equal(part.numpy().view(np.uint32),
                                  _lane_sums_numpy(bits).view(np.uint32))
            continue
        if b.scheme == C.SCHEME_ALP:
            vals = kfalp.falp_plain(b.args[0], b.bw, *b.args[1:]).numpy()
        else:
            right, left, dictionary, dict_size = b.args
            bits = kfalp.rd_plain(right, b.bw, left, b.lbw, dictionary,
                                  dict_size).numpy()
            vals = bits.view(np.float64 if plan.f64 else np.float32)
        terms = vals.astype(np.float32).astype(np.float64)
        tol = terms.size * 2.0**-24 * np.abs(terms).sum()
        assert part.dtype == torch.float32 and part.dim() == 0
        assert abs(float(part) - terms.sum()) <= tol, (b.bw, float(part))
    if name == "zeros":
        assert [b.bw for b in plan.buckets] == [0]
    out = step(ZERO, *args)
    assert out.dtype == torch.int64 and out.dim() == 0


@pytest.mark.parametrize("name", STEP_NAMES)
def test_exact_sum_step_equals_exact_sum_totals(name):
    x, _, col = _columns(name)
    plan = col.plan("cpu")
    step, args = engine.make_exact_sum_step(plan)
    got = step.result(ZERO, *args)
    assert torch.equal(got, engine.exact_sum_totals(plan))
    assert step.answer(got) == engine.host_sum_raw(x)
    assert step(torch.tensor(12345), *args).dim() == 0


@pytest.mark.parametrize("name", STEP_NAMES)
def test_filter_step_equals_query_filter_count(name):
    x, _, col = _columns(name)
    plan = col.plan("cpu")
    fin = np.sort(x[np.isfinite(x)])
    q1, q3 = float(fin[len(fin) // 4]), float(fin[3 * len(fin) // 4])
    for lo, hi in ((q1, q3), (-np.inf, np.inf), (-0.0, q3), (q3, q1),
                   (-np.inf, -np.inf)):
        step, args = engine.make_filter_step(plan, lo, hi)
        got = step.answer(step.result(ZERO, *args))
        assert got == engine.query_filter_count(col, lo, hi, **CPU), (lo, hi)


@pytest.mark.parametrize("name", STEP_NAMES)
def test_topk_step_threshold_and_ties(name):
    """t is the k-th best of the vectors' best keys (K16); the bins at
    [t - 1, t] are K15's prefix counts there."""
    x, _, col = _columns(name)
    plan = col.plan("cpu")
    mask = (1 << (64 if plan.f64 else 32)) - 1
    ext = engine.vector_extremes(plan).numpy().view(
        engine._key_type(x.dtype))
    for largest in (True, False):
        k = min(3, plan.n_vectors)
        step, args = engine.make_topk_step(plan, k, largest)
        t, bins = step.result(ZERO, *args)
        best = np.sort(ext[:, 1] if largest else ext[:, 0])
        want = int(best[-k] if largest else best[k - 1])
        assert int(t) & mask == want
        below = np.cumsum(bins.numpy())
        assert below[:2].tolist() == engine.prefix_counts(
            plan, [max(want, 1) - 1, want]).tolist()
    with pytest.raises(ValueError):
        engine.make_topk_step(plan, plan.n_vectors + 1)


@pytest.mark.parametrize("name", STEP_NAMES)
def test_histogram_step_equals_query_histogram(name):
    x, _, col = _columns(name)
    plan = col.plan("cpu")
    fin = np.sort(x[np.isfinite(x)])
    for edges in ([float(fin[0]), float(fin[-1])],
                  np.linspace(fin[0], fin[-1], 9).tolist(),
                  [-np.inf, -0.0, float(fin[-1]) + 1.0, np.inf]):
        step, args = engine.make_histogram_step(plan, edges)
        got = step.answer(step.result(ZERO, *args))
        assert np.array_equal(got, engine.query_histogram(col, edges, **CPU))


def _same_groups(a, b) -> bool:
    return (a.totals == b.totals and np.array_equal(a.sp, b.sp)
            and np.array_equal(a.ct, b.ct) and np.array_equal(a.kmn, b.kmn)
            and np.array_equal(a.kmx, b.kmx))


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("name", STEP_NAMES)
def test_groupby_step_equals_group_totals(name, ordered):
    x, _, col = _columns(name)
    plan = col.plan("cpu")
    rng = np.random.default_rng(7)
    G = 5
    keys = rng.integers(0, G, len(x))
    if ordered:
        keys = np.sort(keys)
    step, args = engine.make_groupby_step(col, keys, G, plan=plan)
    got = step.answer(step.result(ZERO, *args))
    assert _same_groups(got, engine.group_totals(col, keys, G, **CPU))
    assert step(torch.tensor(3), *args).dim() == 0


def test_steps_take_the_carry():
    """A carry other than 0 perturbs the inputs, so the next value
    differs; the plan itself is left as it was."""
    _, _, col = _columns("mixed_alp_rd")
    plan = col.plan("cpu")
    bases = [b.args[1].clone() for b in plan.buckets]
    step, args = engine.make_exact_sum_step(plan)
    assert not torch.equal(step.result(torch.tensor(1 << 40), *args),
                           step.result(ZERO, *args))
    for b, base in zip(plan.buckets, bases):
        assert torch.equal(b.args[1], base)


# ---------------------------------------------------------------------------
# benchlib and the bench scripts
# ---------------------------------------------------------------------------

def test_loop_bench_on_the_cpu():
    """With ``device="cpu"``, and from a plan alone (steps whose only
    argument is the plan run on the plan's device, not the card)."""
    _, _, col = _columns("bw_le32")
    plan = col.plan("cpu")
    dt = benchlib.loop_bench(*engine.make_sum_step(plan), 3, device="cpu")
    assert dt > 0
    step, args = engine.make_exact_sum_step(plan)
    assert args == (plan,)
    assert benchlib._device_of(args, None) == torch.device("cpu")
    assert benchlib.loop_bench(step, args, 3) > 0
    with pytest.raises(RuntimeError, match="non-positive"):
        benchlib._check(0.0)
    with pytest.raises(RuntimeError, match="non-positive"):
        benchlib._check(float("nan"))


def test_loop_bench_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchlib.loop_bench(lambda c: c, (), 1)


def test_bench_on_the_cpu_prints_the_headline():
    """The headline's parts at 2 rowgroups and 100 vectors a profile on
    the CPU: each profile's numbers, the report, a well-formed last line;
    nothing written under results/."""
    headline = ROOT / "results" / "bench_headline.json"
    before = headline.read_bytes() if headline.exists() else None
    cols = bench.profile_columns(0, 2, 100)
    assert list(cols) == list(columns.BENCH_PROFILES)
    results = {name: bench.bench_column(col, "cpu")
               for name, col in cols.items()}
    for col, r in zip(cols.values(), results.values()):
        assert col.n_vectors == 100
        assert r["gbps"] > 0 and r["kernels_gbps"] > 0
        assert r["decompress_s"] > 0 and r["launches"] >= 1
    err = io.StringIO()
    bench.report(results, out=err)
    assert err.getvalue().count("GB/s decode with the patch") == 5
    last = json.loads(json.dumps(bench.headline(results)))
    assert list(last) == ["metric", "value", "unit", "vs_baseline"]
    assert last["metric"] == "falp_decode_f64_suite_avg"
    assert last["unit"] == "GB/s" and last["value"] > 0
    assert last["value"] == np.mean([r["gbps"] for r in results.values()])
    assert last["vs_baseline"] == last["value"] / 56.0
    assert (headline.read_bytes() if headline.exists() else None) == before


def test_bench_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert bench.main() != 0
        assert bench_speed.main() != 0
    assert out.getvalue() == ""
    assert "no CUDA device" in err.getvalue()


def test_bench_speed_rows_on_the_cpu():
    """Every row at 8 vectors; ``check`` sees each row with its inputs,
    and the K20-K23 rows with a plain step that agrees at carry 0."""
    seen, plains = [], []

    def check(name, step, args, plain):
        seen.append(name)
        if plain is not None:
            plains.append(name)
            got, want = step.result(ZERO, *args), plain.result(ZERO, *args)
            idt = torch.int64 if got.element_size() == 8 else torch.int32
            assert got.dtype == want.dtype and torch.equal(got.view(idt),
                                                           want.view(idt))

    rows = bench_speed.rows(torch.device("cpu"), vectors=8, check=check)
    names = [r[0] for r in rows]
    assert seen == names
    assert plains == ["unffor_f64_bw16", "unffor_f64_bw52",
                      "unffor_f32_bw30", "rd_decode_f64_rbw52",
                      "rd_decode_f32_rbw24", "falp_sum_fused_f64_bw16",
                      "key_extremes_bits_f64"]
    for want in ("falp_f64_bw16", "falp_f64_const_bw0",
                 "falp_sum_exact_fused_f64_bw16", "falp_f32_bw10",
                 "encode_f64_without_sampling", "encode_f32_kernel",
                 "key_extremes", "e2e_sum_query_64MiB",
                 "e2e_exact_sum_query_64MiB", "e2e_filter_count_query_64MiB",
                 "e2e_topk_query_64MiB", "e2e_histogram_query_64MiB",
                 "e2e_groupby_query_64MiB", "e2e_groupby_sorted_query_64MiB"):
        assert want in names
    assert all(r[2] > 0 and r[3] == "GB/s" for r in rows)
