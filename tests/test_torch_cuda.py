"""The port's CUDA kernels on the card (every test is marked ``cuda``).

Each kernel is held against its plain PyTorch version on the same plan
buckets, bit for bit (the SUM kernels' integer totals exactly), the whole
decode against the input, ``query_sum`` against ``math.fsum``, and the
device compress kernels K9-K14 against their plain versions and
``compress_device``'s blob against host compress's, in both precisions,
the key kernels K15/K16/K17 and the filtered SUM against their plain
versions, every predicate and order query on the card against its answer
on the CPU, QUANTILE / MEDIAN on the card against ``np.quantile``, and the
grouped kernels K18/K19 against their plain versions and GROUP-BY, windows
and DISTINCT on the card against their answers on the CPU, a plan
snapshot restored on the card against the built plan, the sharded
paths over NCCL at world sizes 1, 2 and 4 (a size skips on fewer cards)
against the single-device answers, the device compress loop steps against
``compress_device``, and the native competitor codecs' round trip on the
card's host.  This file imports neither JAX nor
``alp_tpu``, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Without a card every test skips.
"""

import math
import struct
from fractions import Fraction

import numpy as np
import pytest
import torch

import alp_tpu_torch
from alp_tpu_torch import constants as C
from alp_tpu_torch import engine
from alp_tpu_torch.columns import route_columns
from alp_tpu_torch.kernels import decode, falp
from alp_tpu_torch.kernels import encode as kenc
from alp_tpu_torch.kernels import exact_sum as kes
from alp_tpu_torch.kernels import ffor as kffor
from alp_tpu_torch.kernels import keys as kkeys
from alp_tpu_torch.kernels import score as kscore
from alp_tpu_torch.ops.keys import bias, biased_keys

pytestmark = pytest.mark.cuda
COLUMNS = route_columns(np.random.default_rng(5),
                        2 * C.N_VECTORS_PER_ROWGROUP)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits_dtype(plan):
    return torch.int64 if plan.f64 else torch.int32


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_kernels_equal_plain_versions(name, cuda):
    plan = decode.build_plan(alp_tpu_torch.compress(COLUMNS[name]), cuda)
    vdt = torch.float64 if plan.f64 else torch.float32
    bits = _bits_dtype(plan)
    for bucket in plan.buckets:
        got = torch.zeros((plan.n_vectors, 1024), dtype=vdt, device=cuda)
        want = torch.zeros_like(got)
        before = sum(falp.LAUNCHES.values())
        plan.launch(bucket, got)
        assert sum(falp.LAUNCHES.values()) == before + 1
        if bucket.scheme == C.SCHEME_ALP:
            want[bucket.rows] = falp.falp_plain(bucket.args[0], bucket.bw,
                                                *bucket.args[1:])
        else:
            right, left, dictionary, dict_size = bucket.args
            want.view(bits)[bucket.rows] = falp.rd_plain(
                right, bucket.bw, left, bucket.lbw, dictionary, dict_size)
        torch.cuda.synchronize()
        assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_decode_on_card_equals_input(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.CompressedColumn.from_bytes(
        alp_tpu_torch.compress(x).to_bytes())
    falp.reset_launches()
    out = alp_tpu_torch.decompress(col)
    assert out.device.type == "cuda"
    assert sum(falp.LAUNCHES.values()) == len(
        decode.build_plan(col, cuda).buckets)
    got = out.cpu().numpy()
    assert np.array_equal(got.view(f"u{got.dtype.itemsize}"),
                          x.view(f"u{x.dtype.itemsize}"))


def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(falp, "falp_plain", refuse)
    monkeypatch.setattr(falp, "rd_plain", refuse)
    monkeypatch.setattr(kenc, "encode_plain", refuse)
    monkeypatch.setattr(kenc, "encode_plain_f32", refuse)
    monkeypatch.setattr(kffor, "ffor_plain", refuse)
    monkeypatch.setattr(kscore, "score_plain", refuse)
    monkeypatch.setattr(kscore, "score_plain_f32", refuse)
    for name in ("key_counts_alp_plain", "key_counts_rd_plain",
                 "key_extremes_alp_plain", "key_extremes_rd_plain",
                 "counts_of_bits", "extremes_of_bits", "rank_pass_alp_plain",
                 "rank_pass_rd_plain", "rank_pass_of_bits"):
        monkeypatch.setattr(kkeys, name, refuse)
    x = COLUMNS["f64_mixed_alp_rd"]
    col = alp_tpu_torch.compress(x)
    alp_tpu_torch.decompress(col)
    kkeys.reset_launches()
    assert alp_tpu_torch.query_filter_count(col, 10.0, 50.0) == int(
        ((x >= 10.0) & (x <= 50.0)).sum())
    assert alp_tpu_torch.query_max(col) == x.max()
    assert alp_tpu_torch.query_median(col) == np.median(x)
    assert all(kkeys.LAUNCHES.values()), kkeys.LAUNCHES
    for reset in (kenc.reset_launches, kffor.reset_launches,
                  kscore.reset_launches):
        reset()
    assert alp_tpu_torch.compress_device(x).to_bytes() == col.to_bytes()
    for name in ("f32_alp", "f32_alp_rd"):
        x32 = COLUMNS[name]
        assert alp_tpu_torch.compress_device(x32).to_bytes() == \
            alp_tpu_torch.compress(x32).to_bytes()
    for launches in (kenc.LAUNCHES, kscore.LAUNCHES):
        assert all(launches.values()), launches
    assert kffor.LAUNCHES["ffor_pack_f64"] and \
        kffor.LAUNCHES["ffor_pack_f32"], kffor.LAUNCHES
    torch.cuda.synchronize()


def test_mixed_devices_raise(cuda):
    n, bw = 2, 3
    with pytest.raises(ValueError):
        falp.falp_decode_f64(
            torch.zeros((n, bw * 16), dtype=torch.int64, device=cuda), bw,
            torch.zeros(n, dtype=torch.int64),
            torch.ones(n, dtype=torch.int64, device=cuda),
            torch.ones(n, dtype=torch.float64, device=cuda))


def _special_sum(x):
    if np.isnan(x).any() or (np.isposinf(x).any() and np.isneginf(x).any()):
        return float("nan")
    if np.isposinf(x).any():
        return float("inf")
    if np.isneginf(x).any():
        return float("-inf")
    return None


def _fsum(x):
    special = _special_sum(x)
    return special if special is not None else math.fsum(
        x.astype(np.float64).tolist())


def _same(a, b):
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return struct.pack("<d", a) == struct.pack("<d", b)


def _sum_cases():
    rng = np.random.default_rng(9)
    adv = np.zeros(2048)
    adv[:7] = [1e300, -1e300, 1.0, 2.0 ** -1000, 1e16, 1.0, -1e16]
    sub_rd = rng.standard_normal(2048)
    sub_rd[[17, 900]] = [5e-324, -3e-310]
    sub_alp = np.round(rng.uniform(-5, 5, 2048), 2)
    sub_alp[[17, 900]] = [5e-324, -3e-310]
    sub32 = rng.standard_normal(2048).astype(np.float32)
    sub32[11] = np.float32(1e-44)
    tail_pi = np.round(rng.uniform(-5, 5, 1500), 2)
    tail_pi[-1] = np.pi
    tail_zero = tail_pi.copy()
    tail_zero[-1] = -0.0
    exc = np.round(rng.uniform(-10, 10, 4096), 2)
    exc[[5, 700, 2049]] = [np.pi, 1e300, -0.0]
    cases = {"adversarial": adv, "subnormal_rd": sub_rd,
             "subnormal_alp": sub_alp, "subnormal_f32": sub32,
             "subnormal_const": np.full(1024, 5e-324),
             "tail_pi": tail_pi, "tail_negzero": tail_zero,
             "exceptions": exc, "one_value": np.array([0.1]),
             "empty": np.zeros(0)}
    for specials in ([np.nan], [np.inf], [-np.inf], [np.inf, -np.inf],
                     [np.nan, np.inf, -np.inf]):
        x = np.round(rng.uniform(-100, 100, 3000), 1)
        x[rng.choice(3000, len(specials), replace=False)] = specials
        cases["specials_" + "_".join(map(str, specials))] = x
    return cases


SUM_CASES = _sum_cases()


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_sum_kernels_equal_plain_versions(name, cuda):
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    for call in engine.sum_calls(plan):
        before = kes.LAUNCHES[call.kernel]
        got = call.launch(kes.totals(plan.bits_dtype, cuda))
        assert kes.LAUNCHES[call.kernel] == before + 1
        assert torch.equal(got, call.plain()), (name, call.kernel, call.bw)


def test_plan_is_kept_once_per_card(cuda):
    col = alp_tpu_torch.compress(COLUMNS["bench_bw20_food_prices"])
    plan = col.plan()
    index = torch.cuda.current_device()
    assert col.plan("cuda") is plan
    assert col.plan(f"cuda:{index}") is plan
    assert col.plan(torch.device("cuda", index)) is plan
    assert list(col._plans) == [f"cuda:{index}"]


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_query_sum_on_card_equals_fsum(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    kes.reset_launches()
    assert _same(alp_tpu_torch.query_sum(col), _fsum(x))
    assert sum(kes.LAUNCHES.values()) > 0
    assert _same(alp_tpu_torch.query_sum(col), _fsum(x))   # cached plan


@pytest.mark.parametrize("name", sorted(SUM_CASES))
def test_query_sum_and_mean_on_card_special_cases(name, cuda):
    x = SUM_CASES[name]
    col = alp_tpu_torch.compress(x)
    assert _same(alp_tpu_torch.query_sum(col), _fsum(x))
    special = _special_sum(x)
    if not len(x):
        want = float("nan")
    elif special is not None:
        want = special
    else:
        want = float(sum(map(Fraction, x.astype(np.float64).tolist()),
                         Fraction(0)) / len(x))
    assert _same(alp_tpu_torch.query_mean(col), want)


def _key(u: int, S: int) -> int:
    """The unsigned total-order key of the S-bit pattern u."""
    sign = 1 << (S - 1)
    u = 0 if u == sign else u
    return ((1 << S) - 1) ^ u if u & sign else u | sign


_SPECIALS64 = [0x7FF8000000000000, 0xFFF8000000000001, 0x7FF0000000000000,
               0xFFF0000000000000, 0x8000000000000000, 0, 1, 0x000FFFFFFFFFFFFF,
               0x7E37E43C8800759C, 0xFE37E43C8800759C, 0x3FF0000000000000]
_SPECIALS32 = [0x7FC00000, 0xFFC00001, 0x7F800000, 0xFF800000, 0x80000000, 0,
               1, 0x007FFFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x3F800000]


def _k7_case(f64: bool, bw: int, n: int, tail: int, wide: bool, seed: int):
    """The arguments of a K7 (f64) or K8 (f32) call, CPU tensors, on seeded
    words: n rows of n + 3 vectors, in no order, the last vector among them
    with its last `tail` positions pad.  Row 0's exceptions cover every
    slot of every lane, row 1 is exceptions only, row 2 has none, the last
    vector has some in its pad, the others ~5 %; their true bits are NaN of
    both signs, +-Inf, -0.0, subnormals, the largest finite values, 1.0
    and random patterns.  `wide`: random words, bases and factors whose
    products wrap, so a warp's values span far more than two windows;
    else small decimals."""
    rng = np.random.default_rng(seed)
    S = 64 if f64 else 32
    wdt = np.int64 if f64 else np.int32
    tc = C.DOUBLE if f64 else C.FLOAT
    L = 1024 // S
    nv = n + 3
    rows = rng.permutation(nv)[:n]
    if nv - 1 not in rows:
        rows[-1] = nv - 1
    info = np.iinfo(wdt)
    if wide:
        packed = rng.integers(info.min, info.max, (n, bw * L), dtype=wdt,
                              endpoint=True)
        base = rng.integers(info.min, info.max, n, dtype=wdt, endpoint=True)
        fact = tc.fact_arr[rng.integers(0, len(tc.fact_arr), n)].astype(wdt)
    else:
        packed = np.zeros((n, bw * L), dtype=wdt)
        if bw:
            packed[:] = rng.integers(0, 1 << min(bw, 62), (n, bw * L)).astype(
                wdt) if bw < S else rng.integers(info.min, info.max,
                                                 (n, bw * L), dtype=wdt)
        base = rng.integers(-500, 500, n).astype(wdt)
        fact = tc.fact_arr[rng.integers(0, 3, n)].astype(wdt)
    frac = tc.frac_arr[rng.integers(0, len(tc.frac_arr), n)]
    specials = _SPECIALS64 if f64 else _SPECIALS32
    n_values = nv * 1024 - tail
    slots = 1024 // L
    per_vec = {}
    for i, vec in enumerate(rows.tolist()):
        if i == 0:
            ks = sorted({L * s + s % L for s in range(slots)}
                        | {L * s + (s + 5) % L for s in range(slots)})
        elif i == 1:
            ks = list(range(1024))
        elif i == 2:
            ks = []
        else:
            ks = sorted(rng.choice(1024, 50, replace=False).tolist())
        if vec == nv - 1 and tail:
            ks = sorted(set(ks) | {1023, 1024 - tail, 1024 - tail - 1})
        per_vec[vec] = ks
    counts = np.array([len(per_vec.get(v, [])) for v in range(nv)])
    exc_ptr = np.concatenate([[0], np.cumsum(counts)])
    exc_index = np.array([v * 1024 + k for v in range(nv)
                          for k in per_vec.get(v, [])], dtype=np.int64)
    pool = np.array(specials, dtype=np.uint64)
    n_exc = len(exc_index)
    true = np.where(rng.random(n_exc) < 0.5, pool[rng.integers(
        0, len(pool), n_exc)], rng.integers(0, 1 << S, n_exc,
                                            dtype=np.uint64))
    exc_bits = true.view(wdt) if f64 else true.astype(np.uint32).view(wdt)
    t = torch.from_numpy
    return (t(packed), bw, t(base), t(fact.astype(wdt)), t(frac),
            t(rows.astype(np.int64)), t(exc_ptr.astype(np.int64)),
            t(exc_index), t(np.ascontiguousarray(exc_bits)), n_values)


def _k7_key_ranges(args, f64: bool) -> list:
    """Key ranges for the filtered instance: all keys, the middle half of
    the summed values, and two exceptions each alone: one range holding
    only its true value (its placeholder dropped), one holding only its
    placeholder (its true value dropped)."""
    S = 64 if f64 else 32
    packed, bw, base, fact, frac, rows, exc_ptr, exc_index, exc_bits, _ = args
    ph = falp.falp_plain(packed, bw, base, fact, frac).view(base.dtype)
    bits = kes.falp_bits_plain(*args[:-1])
    mask = (1 << S) - 1
    keys = sorted(_key(int(u) & mask, S) for u in bits.reshape(-1).tolist())
    ranges = [(0, mask), (keys[len(keys) // 4], keys[3 * len(keys) // 4])]
    where = {int(r): i for i, r in enumerate(rows.tolist())}
    for e in range(exc_index.shape[0]):
        vec, k = divmod(int(exc_index[e]), 1024)
        if vec not in where:
            continue
        u_true = int(exc_bits[e]) & mask
        u_ph = int(ph[where[vec], k]) & mask
        if _key(u_true, S) != _key(u_ph, S):
            ranges += [(_key(u_true, S),) * 2, (_key(u_ph, S),) * 2]
            if len(ranges) >= 6:
                break
    return ranges


@pytest.mark.parametrize("f64", [True, False])
@pytest.mark.parametrize("bw,n,tail,wide", [
    (0, 5, 0, False), (7, 9, 300, False), (11, 33, 1, True),
    (37, 6, 1023, True), (64, 7, 512, True), (32, 8, 5, True),
    (3, 2, 0, False), (1, 1, 17, False)])
def test_k7_k8_edges_equal_plain_versions(cuda, f64, bw, n, tail, wide):
    """K7 / K8 (and their filtered instance) against their plain versions
    by bits on seeded rows: exceptions at every lane and slot of a vector,
    a vector of exceptions only, exceptions in the pad of a partial last
    vector, NaN of both signs, +-Inf, -0.0, subnormals and the largest
    finite values as true bits, warps spanning many digit windows, an odd
    number of rows (half of an f64 warp idle), and key ranges that keep an
    exception's true value but drop its placeholder, and the reverse."""
    S = 64 if f64 else 32
    bw %= S + 1                              # f32 words hold 0..32 bits
    args = _k7_case(f64, bw, n, tail, wide, seed=bw * 100 + n + tail)
    fn = (kes.falp_decode_f64_exact_sum if f64
          else kes.falp_decode_f32_exact_sum)
    name = ("falp_decode_f64_exact_sum" if f64
            else "falp_decode_f32_exact_sum")
    dev_args = [a.to(cuda) if isinstance(a, torch.Tensor) else a
                for a in args]
    before = kes.LAUNCHES[name]
    got = fn(*dev_args)
    assert kes.LAUNCHES[name] == before + 1
    want = kes.falp_exact_sum_plain(*args)
    assert torch.equal(got.cpu(), want), (bw, n, tail, wide)
    assert int(want[-3:].sum()) > 0          # NaN / Inf counts exercised
    for key_range in _k7_key_ranges(args, f64):
        got = fn(*dev_args, key_range=key_range)
        want = kes.falp_exact_sum_plain(*args, key_range=key_range)
        assert torch.equal(got.cpu(), want), key_range


def _sum_rows(f64: bool, n: int, tail: int, seed: int):
    """Seeded K5 (f64) / K6 (f32) arguments, CPU tensors: n rows of n + 3
    vectors in no order, the last vector among them with its last `tail`
    positions pad; rows of random bit patterns (every exponent window, NaN
    of both signs, +-Inf and subnormals among them), of normal values (at
    most two digit windows a warp), of 1e30 beside 1e-30 (more than two),
    of subnormals, of zeros of both signs, and of specials alone."""
    rng = np.random.default_rng(seed)
    S = 64 if f64 else 32
    ut, ft = (np.uint64, np.float64) if f64 else (np.uint32, np.float32)
    nv = n + 3
    vec = rng.permutation(nv)[:n]
    if nv - 1 not in vec:
        vec[-1] = nv - 1
    bits = rng.integers(0, 1 << S, (n, 1024), dtype=np.uint64).astype(ut)
    bits[1::6] = rng.standard_normal((len(bits[1::6]), 1024)).astype(
        ft).view(ut)
    far = np.where(rng.random((len(bits[2::6]), 1024)) < 0.5, 1e30, -1e-30)
    bits[2::6] = (far * rng.random(far.shape)).astype(ft).view(ut)
    sub = rng.integers(1, 1 << (52 if f64 else 23), (len(bits[3::6]), 1024),
                       dtype=np.uint64)
    bits[3::6] = (sub | (rng.integers(0, 2, sub.shape, dtype=np.uint64)
                         << np.uint64(S - 1))).astype(ut)
    bits[4::6] = np.where(rng.random((len(bits[4::6]), 1024)) < 0.5, ut(0),
                          ut(1) << ut(S - 1))
    pool = np.array(_SPECIALS64 if f64 else _SPECIALS32,
                    dtype=np.uint64).astype(ut)
    bits[5::6] = pool[rng.integers(0, len(pool), (len(bits[5::6]), 1024))]
    bits[0, :len(pool)] = pool
    wdt = np.int64 if f64 else np.int32
    return (torch.from_numpy(bits.view(wdt)), torch.from_numpy(vec.astype(
        np.int64)), nv * 1024 - tail)


def _sum_key_ranges(bits: torch.Tensor, f64: bool) -> list:
    """Every key, the middle half of the keys, a range that cuts through
    row 1 (its 300th to its 700th key; row 0 where it is the only one), and
    one key alone."""
    S = 64 if f64 else 32
    mask = (1 << S) - 1
    keys = sorted(_key(int(u) & mask, S) for u in bits.reshape(-1).tolist())
    row = sorted(_key(int(u) & mask, S)
                 for u in bits[min(1, len(bits) - 1)].tolist())
    return [(0, mask), (keys[len(keys) // 4], keys[3 * len(keys) // 4]),
            (row[300], row[700]), (row[512],) * 2]


@pytest.mark.parametrize("f64", [True, False])
@pytest.mark.parametrize("n,tail", [(37, 0), (37, 1), (13, 1023), (12, 513),
                                    (1, 300), (61, 7)])
def test_k5_k6_edges_equal_plain_versions(cuda, f64, n, tail):
    """K5 / K6 (and their filtered instance) against their plain versions
    by bits on seeded rows: random bit patterns (every exponent window,
    subnormals, NaN of both signs, +-Inf), -0.0 and +0.0, warps spanning
    more than two digit windows, a partial last vector, odd and even row
    counts (whole and partial steps of a block's rows), rows out of vector
    order, and key ranges that cut through a row."""
    bits, vec, n_values = _sum_rows(f64, n, tail, seed=n * 1000 + tail)
    fn = kes.exact_sum_f64 if f64 else kes.exact_sum_f32
    name = "exact_sum_f64" if f64 else "exact_sum_f32"
    before = kes.LAUNCHES[name]
    got = fn(bits.to(cuda), vec.to(cuda), n_values)
    assert kes.LAUNCHES[name] == before + 1
    want = kes.exact_sum_plain(bits, vec, n_values)
    assert torch.equal(got.cpu(), want), (n, tail)
    assert int(want[-3:].sum()) > 0          # NaN / Inf counts exercised
    for key_range in _sum_key_ranges(bits, f64):
        got = fn(bits.to(cuda), vec.to(cuda), n_values, key_range=key_range)
        want = kes.exact_sum_plain(bits, vec, n_values, key_range)
        assert torch.equal(got.cpu(), want), key_range


def test_k5_k6_refuse_misaligned_rows(cuda):
    """K5/K6 read 16 bytes at a time: rows that do not start on 16 bytes
    raise instead of reading astray."""
    for dt, fn in ((torch.int64, kes.exact_sum_f64),
                   (torch.int32, kes.exact_sum_f32)):
        flat = torch.zeros(2 * 1024 + 1, dtype=dt, device=cuda)
        with pytest.raises(RuntimeError):
            fn(flat[1:].view(2, 1024), torch.arange(2, device=cuda), 2048)


@pytest.mark.parametrize("S,rbw", [(64, r) for r in range(65)] +
                         [(32, r) for r in range(33)])
def test_k3_k4_every_bit_width(cuda, S, rbw):
    """K3 (S = 64) / K4 (S = 32) at every right bit width and left bit
    widths 0, 1, 2, 3, 8 and 16 on seeded random words, dictionary sizes
    0-8 with indexes past the dictionary, and 37 vectors (not a multiple
    of a block's vectors), written as a new output and into permuted rows
    of a larger one (the others left as they were), against the plain
    version by bits; every other case reads its dictionary from an address
    that is not 16-byte aligned."""
    g = torch.Generator(device=cuda).manual_seed(S * 100 + rbw)
    n = 37
    dt = torch.int64 if S == 64 else torch.int32
    fn = falp.rd_decode_dict_f64 if S == 64 else falp.rd_decode_dict_f32
    name = "rd_decode_dict_f64" if S == 64 else "rd_decode_dict_f32"

    def words(dtype, *shape):
        info = torch.iinfo(dtype)
        return torch.empty(shape, dtype=dtype, device=cuda).random_(
            info.min, info.max, generator=g)

    for i, lbw in enumerate((0, 1, 2, 3, 8, 16)):
        right = words(dt, n, rbw * 1024 // S)
        left = words(torch.int16, n, lbw * 64)
        dictionary = words(torch.int16, n, 8)
        if i % 2:
            dictionary = torch.cat([words(torch.int16, 1), dictionary.view(
                -1)])[1:].view(n, 8)
        dict_size = torch.randint(0, 9, (n,), dtype=torch.int32,
                                  generator=g, device=cuda)
        want = falp.rd_plain(right, rbw, left, lbw, dictionary, dict_size)
        before = falp.LAUNCHES[name]
        got = fn(right, rbw, left, lbw, dictionary, dict_size)
        assert falp.LAUNCHES[name] == before + 1
        assert torch.equal(got, want), (rbw, lbw)
        rows = torch.randperm(n + 5, generator=g, device=cuda)[:n]
        out = torch.full((n + 5, 1024), 7, dtype=dt, device=cuda)
        fn(right, rbw, left, lbw, dictionary, dict_size, out=out, rows=rows)
        sentinel = torch.full_like(out, 7)
        sentinel[rows] = want
        assert torch.equal(out, sentinel), (rbw, lbw)


def test_sum_kernels_refuse_cpu_out_for_cuda_input(cuda):
    bits = torch.zeros((2, 1024), dtype=torch.int64, device=cuda)
    vec = torch.arange(2, device=cuda)
    with pytest.raises(ValueError):
        kes.exact_sum_f64(bits, vec, 2048,
                          out=torch.zeros(69, dtype=torch.int64))


# ---------------------------------------------------------------------------
# device compress: K9-K11 and compress_device
# ---------------------------------------------------------------------------

F64 = sorted(name for name, x in COLUMNS.items() if x.dtype == np.float64)
F32 = sorted(name for name, x in COLUMNS.items() if x.dtype == np.float32)


def _encode_case(rng, n=64):
    vals = np.round(rng.uniform(-500, 500, (n, 1024)), 2)
    vals[1] = rng.standard_normal(1024) * 1e6
    vals[2, :6] = [np.nan, -np.inf, np.inf, -0.0, 0.0, 1e308]
    vals[3] = np.nan
    vals[4, 10:20] = [5e-324, -1e-310, 2.0**53, -(2.0**55), 2.0**60, 1e18,
                      -1e17, 9.2e18, -9.3e18, 2.0**-1074]
    e = rng.integers(0, 19, n).astype(np.int32)
    f = np.minimum(rng.integers(0, 19, n), e).astype(np.int32)
    return (torch.from_numpy(vals), torch.from_numpy(e),
            torch.from_numpy(f))


@pytest.mark.parametrize("stats", [True, False])
def test_k9_equals_its_plain_version(cuda, stats):
    vals, e, f = _encode_case(np.random.default_rng(1))
    before = kenc.LAUNCHES["alp_encode_f64"]
    got = kenc.alp_encode_f64(vals.to(cuda), e.to(cuda), f.to(cuda),
                              stats=stats)
    assert kenc.LAUNCHES["alp_encode_f64"] == before + 1
    want = kenc.encode_plain(vals, e, f, stats)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("bw", [1, 7, 31, 32, 33, 52, 63, 64])
def test_k10_equals_its_plain_version(cuda, bw):
    rng = np.random.default_rng(bw)
    t = torch.from_numpy
    ints = t(rng.integers(-2**63, 2**63, (40, 1024), dtype=np.int64))
    base = t(rng.integers(-2**63, 2**63, 40, dtype=np.int64))
    exc = t(rng.random((40, 1024)) < 0.05)
    fill = t(rng.integers(-2**40, 2**40, 40, dtype=np.int64))
    rows = t(np.array([3, 39, 0, 17]))
    for kw in ({}, {"exc": exc, "fill": fill}, {"rows": rows}):
        dev = {k: v.to(cuda) for k, v in kw.items()}
        got = kffor.ffor_pack_f64(ints.to(cuda), base.to(cuda), bw, **dev)
        want = kffor.ffor_plain(ints, base, bw, kw.get("exc"),
                                kw.get("fill"), kw.get("rows"))
        assert torch.equal(got.cpu(), want), kw
    out = torch.zeros(4 * 16 * bw + 5, dtype=torch.int64, device=cuda)
    offsets = t(np.array([5, 5 + 48 * bw, 5 + 16 * bw, 5 + 32 * bw]))
    kffor.ffor_pack_f64(ints.to(cuda), base.to(cuda), bw, rows=rows.to(cuda),
                        out=out, offsets=offsets.to(cuda))
    want = kffor.ffor_plain(ints, base, bw, rows=rows)
    for r, o in enumerate(offsets.tolist()):
        assert torch.equal(out[o:o + 16 * bw].cpu(), want[r])


def test_k11_equals_its_plain_version(cuda):
    rng = np.random.default_rng(2)
    x = np.round(rng.uniform(-100, 100, (3, 9, 32)), 2)
    x[0, 0, :6] = [np.nan, np.inf, -np.inf, -0.0, 5e-324, -(2.0**63)]
    x[1, 1] = np.nan
    x[2] = rng.standard_normal((9, 32)) * 1e12
    samples = torch.from_numpy(x)
    got = kscore.first_level_scores_f64(samples.to(cuda))
    want = kscore.first_level_scores_f64(samples)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    strides = samples.reshape(-1, 32)
    n = strides.shape[0]
    e = rng.integers(0, 19, (n, 5))
    combos = torch.from_numpy(np.stack(
        [e, rng.integers(0, 19, (n, 5)) % (e + 1)], -1).astype(np.int32))
    k = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    got = kscore.second_level_scores_f64(strides.to(cuda), combos.to(cuda),
                                         k.to(cuda))
    assert torch.equal(got.cpu(),
                       kscore.second_level_scores_f64(strides, combos, k))


def _encode_case32(rng, n=64):
    vals = np.round(rng.uniform(-500, 500, (n, 1024)), 2).astype(np.float32)
    vals[1] = rng.standard_normal(1024).astype(np.float32) * 1e4
    vals[2, :6] = [np.nan, -np.inf, np.inf, -0.0, 0.0, 3e38]
    vals[3] = np.nan
    vals[4, 10:20] = [1e-44, -1e-40, 1.4e-45, 2.2e7, -2.2e7, 2147483520.0,
                      -2147483648.0, 1e30, -1e30, 21474836.0]
    e = rng.integers(0, 11, n).astype(np.int32)
    f = np.minimum(rng.integers(0, 11, n), e).astype(np.int32)
    e[:2], f[:2] = 10, 10                 # past the FACT table: all exceptions
    return (torch.from_numpy(vals), torch.from_numpy(e),
            torch.from_numpy(f))


@pytest.mark.parametrize("stats", [True, False])
def test_k12_equals_its_plain_version(cuda, stats):
    vals, e, f = _encode_case32(np.random.default_rng(1))
    before = kenc.LAUNCHES["alp_encode_f32"]
    got = kenc.alp_encode_f32(vals.to(cuda), e.to(cuda), f.to(cuda),
                              stats=stats)
    assert kenc.LAUNCHES["alp_encode_f32"] == before + 1
    want = kenc.encode_plain_f32(vals, e, f, stats)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("bw", [1, 7, 15, 16, 17, 31, 32])
def test_k13_equals_its_plain_version(cuda, bw):
    rng = np.random.default_rng(bw)
    t = torch.from_numpy
    ints = t(rng.integers(-2**31, 2**31, (40, 1024)).astype(np.int32))
    base = t(rng.integers(-2**31, 2**31, 40).astype(np.int32))
    exc = t(rng.random((40, 1024)) < 0.05)
    fill = t(rng.integers(-2**20, 2**20, 40).astype(np.int32))
    rows = t(np.array([3, 39, 0, 17]))
    for kw in ({}, {"exc": exc, "fill": fill}, {"rows": rows}):
        dev = {k: v.to(cuda) for k, v in kw.items()}
        before = kffor.LAUNCHES["ffor_pack_f32"]
        got = kffor.ffor_pack_f32(ints.to(cuda), base.to(cuda), bw, **dev)
        assert kffor.LAUNCHES["ffor_pack_f32"] == before + 1
        want = kffor.ffor_plain(ints, base, bw, kw.get("exc"),
                                kw.get("fill"), kw.get("rows"))
        assert torch.equal(got.cpu(), want), kw
    out = torch.zeros(4 * 32 * bw + 5, dtype=torch.int32, device=cuda)
    offsets = t(np.array([5, 5 + 96 * bw, 5 + 32 * bw, 5 + 64 * bw]))
    kffor.ffor_pack_f32(ints.to(cuda), base.to(cuda), bw, rows=rows.to(cuda),
                        out=out, offsets=offsets.to(cuda))
    want = kffor.ffor_plain(ints, base, bw, rows=rows)
    for r, o in enumerate(offsets.tolist()):
        assert torch.equal(out[o:o + 32 * bw].cpu(), want[r])


def test_k14_equals_its_plain_version(cuda):
    rng = np.random.default_rng(2)
    x = np.round(rng.uniform(-100, 100, (3, 9, 32)), 2).astype(np.float32)
    x[0, 0, :8] = [np.nan, np.inf, -np.inf, -0.0, 1e-44, -2147483648.0,
                   3e38, 2.2e7]
    x[0, 1, ::2] = -0.0
    x[1, 1] = np.nan
    x[2] = rng.standard_normal((9, 32)).astype(np.float32) * 1e4
    samples = torch.from_numpy(x)
    before = kscore.LAUNCHES["score_pairs_f32"]
    got = kscore.first_level_scores_f32(samples.to(cuda))
    assert kscore.LAUNCHES["score_pairs_f32"] == before + 1
    want = kscore.first_level_scores_f32(samples)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    strides = samples.reshape(-1, 32)
    n = strides.shape[0]
    e = rng.integers(0, 11, (n, 5))
    combos = torch.from_numpy(np.stack(
        [e, rng.integers(0, 11, (n, 5)) % (e + 1)], -1).astype(np.int32))
    k = torch.from_numpy(rng.integers(0, 6, n).astype(np.int32))
    got = kscore.second_level_scores_f32(strides.to(cuda), combos.to(cuda),
                                         k.to(cuda))
    assert torch.equal(got.cpu(),
                       kscore.second_level_scores_f32(strides, combos, k))


def _score_samples(rng, n, f64):
    """Seeded segments of 32 samples: decimals, and segments of NaN only
    (every trial an exception: max - min wraps to 1), of NaN, +-Inf, -0.0,
    subnormals and huge values, and of wide random values."""
    dt = np.float64 if f64 else np.float32
    x = np.round(rng.uniform(-100, 100, (n, 32)), 2).astype(dt)
    x[0] = np.nan
    x[1, :8] = [np.nan, np.inf, -np.inf, -0.0, 5e-324 if f64 else 1e-45,
                -(2.0 ** 63), 3e38, 1e-40]
    x[2, ::2] = -0.0
    x[3] = (rng.standard_normal(32) * 1e12).astype(dt)
    x[4] = np.inf
    return torch.from_numpy(x)


def _score_pairs(rng, shape, f64):
    top = C.DOUBLE.max_exponent if f64 else C.FLOAT.max_exponent
    e = rng.integers(0, top + 1, shape)
    f = rng.integers(0, top + 1, shape) % (e + 1)
    ef = np.stack([e, f], -1)
    flat = ef.reshape(-1, 2)
    flat[:2] = [[top, top], [0, 0]][:len(flat)]
    return torch.from_numpy(ef.astype(np.int32))


@pytest.mark.parametrize("f64", [True, False])
@pytest.mark.parametrize("n_cand,n,shared,counted", [
    (1, 200, False, False), (1, 130, True, False), (5, 103, False, True),
    (5, 52, True, False), (190, 7, True, False), (66, 11, True, True),
    (300, 5, False, True)])
def test_k11_k14_edges_equal_plain_versions(cuda, f64, n_cand, n, shared,
                                            counted):
    """K11 / K14 at 1, 5, 66, 190 and 300 candidates (more than a block's
    threads), pairs shared by every segment or a segment's own, with and
    without k_count (0..n_cand a segment), segment counts that leave a
    block partly empty, and segments of NaN only, of specials and of
    huge values, against the plain versions by bits."""
    rng = np.random.default_rng(n_cand * 1000 + n + 7 * shared)
    samples = _score_samples(rng, n, f64)
    ef = _score_pairs(rng, (1 if shared else n, n_cand), f64)
    k = (torch.from_numpy(rng.integers(0, n_cand + 1, n).astype(np.int32))
         if counted else None)
    fn = kscore.score_pairs_f64 if f64 else kscore.score_pairs_f32
    plain = kscore.score_plain if f64 else kscore.score_plain_f32
    name = "score_pairs_f64" if f64 else "score_pairs_f32"
    before = kscore.LAUNCHES[name]
    got = fn(samples.to(cuda), ef.to(cuda), None if k is None else k.to(cuda))
    assert kscore.LAUNCHES[name] == before + 1
    want = plain(samples, ef, k)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w), (n_cand, n, shared, counted)
    # a segment of NaN only: every trial an exception, INT_MIN / INT_MAX
    # wrap to a width of 1
    exc = kscore.EXC_BITS if f64 else kscore.EXC_BITS32
    live = torch.ones(n_cand, dtype=torch.bool) if k is None else (
        torch.arange(n_cand) < int(k[0]))
    assert bool((want[0][0][live] == 32 + 32 * exc).all())


@pytest.mark.parametrize("name", F64 + F32)
def test_compress_device_equals_host_compress(name, cuda):
    x = COLUMNS[name]
    want = alp_tpu_torch.compress(x)
    assert alp_tpu_torch.compress_device(x).to_bytes() == want.to_bytes()
    assert alp_tpu_torch.compress(x, device=True).to_bytes() == \
        want.to_bytes()
    decoded = alp_tpu_torch.decompress(want)
    got = alp_tpu_torch.compress_device(values=decoded,
                                        n_values=want.n_values)
    assert got.to_bytes() == want.to_bytes()


def test_sum_in_runs_on_the_card(cuda):
    x = COLUMNS["f64_mixed_alp_rd"]
    plan = alp_tpu_torch.compress(x).plan(cuda)
    whole = engine.exact_sum_totals(plan)
    runs = engine.exact_sum_totals(plan, run_values=7 * 1024 + 1)
    assert runs.shape[0] > 1
    assert engine.join_totals(runs.tolist(), x.dtype) == \
        engine.join_totals(whole.tolist(), x.dtype)


def test_work_runs_on_the_tensors_card():
    """Decode, SUM, device compress, the queries, the bench's kernels and
    the loop steps, timed by loop_bench from their plan alone, on card 1
    while card 0 is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    x = COLUMNS["f64_mixed_alp_rd"]
    col = alp_tpu_torch.compress(x)
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        out = alp_tpu_torch.decompress(col, other)
        assert out.device == other
        assert np.array_equal(out.cpu().numpy().view(np.uint64),
                              x.view(np.uint64))
        assert _same(alp_tpu_torch.query_sum(col, other), _fsum(x))
        assert alp_tpu_torch.compress_device(x, device=other).to_bytes() \
            == col.to_bytes()
        got = alp_tpu_torch.compress_device(values=out,
                                            n_values=col.n_values)
        assert got.to_bytes() == col.to_bytes()
        x32 = COLUMNS["f32_alp_rd"]
        assert alp_tpu_torch.compress_device(x32, device=other).to_bytes() \
            == alp_tpu_torch.compress(x32).to_bytes()
        assert alp_tpu_torch.query_filter_count(col, 10.0, 50.0, other) \
            == int(((x >= 10.0) & (x <= 50.0)).sum())
        assert alp_tpu_torch.query_min(col, other) == x.min()
        np.testing.assert_array_equal(
            alp_tpu_torch.query_topk(col, 5, device=other),
            np.sort(x)[::-1][:5])
        np.testing.assert_array_equal(
            alp_tpu_torch.query_quantile(col, [0.1, 0.5, 0.9], device=other),
            np.quantile(x, [0.1, 0.5, 0.9]))
        keys = np.arange(len(x)) % 5
        for got, want in (
                (alp_tpu_torch.query_groupby(col, keys, 5, device=other),
                 alp_tpu_torch.query_groupby(col, keys, 5, device="cpu")),
                (alp_tpu_torch.query_window(col, 5000, hop=1000,
                                            device=other),
                 alp_tpu_torch.query_window(col, 5000, hop=1000,
                                            device="cpu"))):
            assert list(got) == list(want)
            for a in got:
                assert _same_array(got[a], want[a]), a
        assert alp_tpu_torch.query_distinct(col, other) == len(np.unique(x))
        # the bench's kernels K20-K23 and a loop step on card 1
        from alp_tpu_torch.kernels import group as kgroup
        from alp_tpu_torch.ops.fastlanes import unffor_unpack
        plan = decode.build_plan(col, other)
        bits = plan.run().view(torch.int64)
        for b in plan.buckets:
            if b.scheme == C.SCHEME_ALP:
                host = [a.cpu() for a in b.args]
                got = falp.variant_sum_f64(b.args[0], b.bw, *b.args[1:])
                assert got.device == other and torch.equal(
                    got.cpu(), falp.variant_sum_plain(host[0], b.bw,
                                                      *host[1:]))
                got = kffor.unffor(b.args[0], b.bw, b.args[1])
                assert got.device == other and torch.equal(
                    got.cpu(), unffor_unpack(host[0], host[1], b.bw))
            else:
                want = bits[b.rows]
                got = falp.rd_glue_f64(b.args[0], b.bw,
                                       _left_parts(want, b.bw))
                assert got.device == other and torch.equal(got, want)
        got = kgroup.key_extremes_bits_f64(bits)
        assert got.device == other and torch.equal(
            got.cpu(), kgroup.key_extremes_bits_plain(bits.cpu()))
        step, args = engine.make_exact_sum_step(plan)
        zero = torch.zeros((), dtype=torch.int64, device=other)
        assert torch.equal(step.result(zero, *args),
                           engine.exact_sum_totals(plan))
        from alp_tpu_torch import benchlib
        for make in (engine.make_exact_sum_step, engine.make_sum_step):
            assert benchlib.loop_bench(*make(plan), 3) > 0
        torch.cuda.synchronize(other)
        assert torch.cuda.current_device() == 0


# ---------------------------------------------------------------------------
# predicate and order queries: K15, K16, the filtered K5-K8
# ---------------------------------------------------------------------------

K15_SMALL = 2           # csrc/keys.cu kSmall: K15 without a search


def _thresholds(plan, n: int, seed: int) -> torch.Tensor:
    """n ascending distinct unsigned keys (held in the bit patterns' signed
    dtype): keys of the column's own values, then random keys."""
    rng = np.random.default_rng(seed)
    ut = np.uint64 if plan.f64 else np.uint32
    own = engine.vector_extremes(plan).cpu().numpy().view(ut).ravel()
    rand = rng.integers(0, np.iinfo(ut).max, 4 * n, dtype=ut,
                        endpoint=True)
    keys = np.unique(np.concatenate([own[:n // 2], rand]))
    keys = np.sort(rng.choice(keys, n, replace=False))
    return torch.from_numpy(keys.view(f"i{keys.itemsize}").copy()).to(
        plan.device)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_key_kernels_equal_plain_versions(name, cuda):
    """K15 on both sides of its few-threshold path (E <= K15_SMALL), at the
    bench histogram's 7, and across the chunks of 2048, and K16, on every
    bucket, bit for bit."""
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    for E in (1, K15_SMALL, K15_SMALL + 1, 7, 16, 17, 2048, 2049):
        thr = _thresholds(plan, E, E)
        for call in engine.key_calls(plan):
            before = kkeys.LAUNCHES["key_counts"]
            got = call.counts(thr, torch.zeros(E + 1, dtype=torch.int64,
                                               device=cuda))
            assert kkeys.LAUNCHES["key_counts"] == before + -(-E // 2048)
            assert torch.equal(got, call.counts_plain(thr)), (name, E)
    out = torch.zeros((plan.n_vectors, 2), dtype=plan.bits_dtype,
                      device=cuda)
    for call in engine.key_calls(plan):
        before = kkeys.LAUNCHES["key_extremes"]
        call.extremes(out)
        assert kkeys.LAUNCHES["key_extremes"] == before + 1
        assert torch.equal(out[call.rows], call.extremes_plain()), name


def _edge_columns() -> dict:
    """name -> (column, the count of vectors whose every value is an
    exception) of the key kernels' edges: among decimals (ALP) a vector of
    NaN and one of huge values, among normals (ALP_RD) a vector of tiny
    negatives, in f64 and f32, and a constant column with a tail (bit
    width 0: a warp's keys all in one bin)."""
    rng = np.random.default_rng(15)
    n = 2 * C.N_VECTORS_PER_ROWGROUP * 1024
    cols = {}
    for dt, huge, tiny in ((np.float64, 1e300, 1e-300),
                           (np.float32, 1e30, 1e-41)):
        alp = np.round(rng.uniform(-50, 50, n), 2).astype(dt)
        alp[5 * 1024:6 * 1024] = np.nan
        alp[7 * 1024:8 * 1024] = (rng.standard_normal(1024) * huge).astype(dt)
        rd = rng.standard_normal(n).astype(dt)
        rd[3 * 1024:4 * 1024] = (-np.abs(rng.standard_normal(1024))
                                 * tiny).astype(dt)
        bits = np.dtype(dt).itemsize * 8
        cols[f"all_exceptions_alp_f{bits}"] = (alp, 2)
        cols[f"all_exceptions_rd_f{bits}"] = (rd, 1)
    cols["constant_tail"] = (np.full(n + 100, -7.25), 0)
    return cols


EDGE_COLUMNS = _edge_columns()


def _reversed_call(call):
    """The bucket of ``call`` with its rows in reversed vector order."""
    per_row = (0, 2, 3, 4, 5) if call.scheme == "alp" else (0, 2, 4, 5, 6)
    args = tuple(a.flip(0).contiguous() if j in per_row else a
                 for j, a in enumerate(call.args))
    return engine.KeyCall(call.scheme, args, call.rows.flip(0).contiguous(),
                          call.bw)


def _edge_thresholds(x: np.ndarray, plan) -> list:
    """Ascending unsigned keys for K15: 0 alone, all ones alone, both, and
    both among the column's own keys and random ones, at one more than
    K15_SMALL, at 17 and at MAX_THRESHOLDS."""
    rng = np.random.default_rng(16)
    ut = np.uint64 if plan.f64 else np.uint32
    top = np.iinfo(ut).max
    bits = torch.from_numpy(x.view(f"i{x.itemsize}").copy())
    own = np.unique(bias(biased_keys(bits)).numpy().view(ut))
    out = [np.array([0], ut), np.array([top], ut), np.array([0, top], ut)]
    for E in (K15_SMALL + 1, 17, kkeys.MAX_THRESHOLDS):
        pool = np.unique(np.concatenate([
            rng.choice(own, min(E, len(own)), replace=False),
            rng.integers(1, top, E, dtype=ut)]))
        pool = pool[(pool != 0) & (pool != top)]
        mid = rng.choice(pool, E - 2, replace=False)
        out.append(np.sort(np.concatenate([out[2], mid])))
    return out


@pytest.mark.parametrize("name", sorted(EDGE_COLUMNS))
def test_key_kernels_on_edges_equal_plain_versions(name, cuda):
    """K15 (its few-threshold path and its search tree) and K16 on every
    bucket, and on every bucket with its rows in reversed vector order,
    bit for bit: vectors whose every value is an exception, a constant
    column with a partial last vector, thresholds 0 and all ones; the
    buckets' K15 bins added into one tensor, and K16 writing only its own
    rows of ``out``."""
    x, n_full = EDGE_COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    assert int((np.asarray(col.exc_count) == 1024).sum()) == n_full
    plan = col.plan(cuda)
    calls = engine.key_calls(plan)
    calls += [_reversed_call(c) for c in calls]
    for thr in _edge_thresholds(x, plan):
        thr_t = _as_words(plan, thr)
        total = torch.zeros(len(thr) + 1, dtype=torch.int64, device=cuda)
        for call in calls:
            got = call.counts(thr_t, torch.zeros(
                len(thr) + 1, dtype=torch.int64, device=cuda))
            assert torch.equal(got, call.counts_plain(thr_t)), (name,
                                                                len(thr))
            call.counts(thr_t, total)
        want = sum(c.counts_plain(thr_t) for c in calls)
        assert torch.equal(total, want), (name, len(thr))
        assert int(total.sum()) == 2 * col.n_values
    for call in calls:
        out = torch.full((plan.n_vectors, 2), 7, dtype=plan.bits_dtype,
                         device=cuda)
        call.extremes(out)
        assert torch.equal(out[call.rows], call.extremes_plain()), name
        others = torch.ones(plan.n_vectors, dtype=torch.bool, device=cuda)
        others[call.rows] = False
        assert bool((out[others] == 7).all()), name


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_filtered_sum_kernels_equal_plain_versions(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    plan = col.plan(cuda)
    width = 64 if plan.f64 else 32
    lo, hi = np.quantile(x[np.isfinite(x)], [0.25, 0.75])
    ranges = [(engine._float_key(lo, x.dtype), engine._float_key(hi, x.dtype)),
              (0, (1 << width) - 1)]
    for key_range in ranges:
        for call in engine.sum_calls(plan, key_range):
            got = call.launch(kes.totals(plan.bits_dtype, cuda))
            assert torch.equal(got, call.plain()), (name, call.kernel)
    # the whole key range sums what the unfiltered kernels sum
    assert torch.equal(engine.exact_sum_totals(plan, key_range=ranges[1]),
                       engine.exact_sum_totals(plan))


def _same_array(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_queries_on_card_equal_cpu(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    fin = x[np.isfinite(x)]
    lo, hi = np.quantile(fin, [0.2, 0.6])
    for a, b in ((lo, hi), (-np.inf, np.inf), (-0.0, hi)):
        assert alp_tpu_torch.query_filter_count(col, a, b) == \
            alp_tpu_torch.query_filter_count(col, a, b, device="cpu")
        assert _same(float(alp_tpu_torch.query_filter_sum(col, a, b)),
                     float(alp_tpu_torch.query_filter_sum(col, a, b,
                                                          device="cpu")))
    for q in (alp_tpu_torch.query_min, alp_tpu_torch.query_max):
        assert _same(q(col), q(col, device="cpu"))
    for k in (1, 5, 128, col.n_vectors + 3):
        for largest in (True, False):
            assert _same_array(
                alp_tpu_torch.query_topk(col, k, largest),
                alp_tpu_torch.query_topk(col, k, largest, device="cpu"))
    for edges in (np.linspace(fin.min() - 1, fin.max() + 1, 7),
                  np.linspace(fin.min() - 1, fin.max() + 1, 2500)):
        assert np.array_equal(
            alp_tpu_torch.query_histogram(col, edges),
            alp_tpu_torch.query_histogram(col, edges, device="cpu"))


# ---------------------------------------------------------------------------
# QUANTILE / MEDIAN: K17
# ---------------------------------------------------------------------------

def _brackets(plan, R: int, seed: int) -> torch.Tensor:
    """R brackets of unsigned keys (held in the signed dtype): between the
    column's own keys, one of a single key, one that holds no key of the
    column, the whole key space."""
    rng = np.random.default_rng(seed)
    ut = np.uint64 if plan.f64 else np.uint32
    own = np.unique(engine.vector_extremes(plan).cpu().numpy().view(ut))
    pairs = [(0, np.iinfo(ut).max), (own[0], own[0])]
    if own[0] > 0:
        pairs.append((own[0] - 1, own[0] - 1))
    while len(pairs) < R:
        a, b = np.sort(rng.choice(own, 2))
        pairs.append((a, b))
    br = np.array(pairs[:R], ut)
    return torch.from_numpy(br.view(f"i{br.itemsize}").copy()).to(
        plan.device)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_k17_equals_its_plain_version(name, cuda):
    """R brackets from 1 to ``MAX_RANKS`` (32), on both sides of 8, at a
    tree of 2 and of 2048 thresholds."""
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    for T in (2, 2048):
        thr = _thresholds(plan, T, T)
        for R in (1, 4, 8, 9, 20, kkeys.MAX_RANKS):
            br = _brackets(plan, R, R)
            for call in engine.key_calls(plan):
                before = kkeys.LAUNCHES["rank_pass"]
                bins, mm = call.rank_pass(thr, br, *kkeys.rank_outputs(
                    T, R, plan.bits_dtype, cuda))
                assert kkeys.LAUNCHES["rank_pass"] == before + 1
                want_bins, want_mm = call.rank_pass_plain(thr, br)
                assert torch.equal(bins, want_bins), (name, T, R)
                assert torch.equal(mm, want_mm), (name, T, R)


def _as_words(plan, keys) -> torch.Tensor:
    """Unsigned numpy keys as the signed words the kernels take."""
    keys = np.ascontiguousarray(keys, np.uint64 if plan.f64 else np.uint32)
    return torch.from_numpy(keys.view(f"i{keys.itemsize}").copy()).to(
        plan.device)


def _all_keys(name: str, plan) -> np.ndarray:
    """The column's distinct unsigned total-order keys, ascending."""
    x = COLUMNS[name]
    bits = torch.from_numpy(x.view(f"i{x.itemsize}").copy())
    keys = bias(biased_keys(bits)).numpy()
    return np.unique(keys.view(np.uint64 if plan.f64 else np.uint32))


def _k17_cases(name: str, plan):
    """(label, unsigned thresholds, [R, 2] unsigned brackets) of K17's
    edges: trees partly full (T in 1, 2, 31, 32, 33, 2047, 2048); brackets
    that overlap, hold no key (between two keys, reversed) or one key; T
    thresholds clustered in R narrow bands, each band a bracket, as the
    bisection places its probes after its first pass."""
    rng = np.random.default_rng(17)
    ut = np.uint64 if plan.f64 else np.uint32
    top = np.iinfo(ut).max
    keys = _all_keys(name, plan)
    own = np.unique(engine.vector_extremes(plan).cpu().numpy().view(ut))
    a, b, c, d = np.sort(rng.choice(keys, 4))
    gaps = np.nonzero(np.diff(keys) > 1)[0]
    empty = ((keys[gaps[0]] + 1, keys[gaps[0] + 1] - 1) if len(gaps)
             else (keys[0] - 1, keys[0] - 1) if keys[0] > 0
             else (keys[-1] + 1, top))
    brackets = np.array([(a, c), (b, d), empty, (own[0], own[0]),
                         (d, a), (0, top), (a, c), (keys[-1], keys[-1])], ut)
    cases = []
    for T in (1, 2, 31, 32, 33, 2047, 2048):
        thr = np.unique(np.concatenate([
            rng.choice(keys, min(T, len(keys)) // 2),
            rng.integers(0, top, T, dtype=ut, endpoint=True)]))
        thr = np.sort(rng.choice(thr, min(T, len(thr)), replace=False))
        cases.append((f"T={T}", thr, brackets[:1 + T % 8]))
    R = 8
    at = np.sort(rng.choice(len(keys), R))
    bands = np.stack([keys[at], keys[np.minimum(at + 3, len(keys) - 1)]], 1)
    m = 2046 // R
    probes = np.unique(np.array(
        [int(lo) + (int(hi) - int(lo)) * j // m for lo, hi in bands
         for j in range(m)] + [int(k) for k in bands.ravel()], ut))
    cases.append(("bands", probes[:2048], bands))
    return cases


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_k17_edges_equal_its_plain_version(name, cuda):
    """K17 on its edges (``_k17_cases``) on every bucket, bit for bit: the
    bw-0 column puts every value in one bin (the uniform-warp path), the
    specials column holds NaN of both signs, +-Inf, -0.0 and a partial
    last vector."""
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    for label, thr, br in _k17_cases(name, plan):
        thr_t, br_t = _as_words(plan, thr), _as_words(plan, br)
        for call in engine.key_calls(plan):
            bins, mm = call.rank_pass(thr_t, br_t, *kkeys.rank_outputs(
                len(thr), len(br), plan.bits_dtype, cuda))
            want_bins, want_mm = call.rank_pass_plain(thr_t, br_t)
            assert torch.equal(bins, want_bins), (name, label)
            assert torch.equal(mm, want_mm), (name, label)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_k17_wide_first_and_later_passes_equal_its_plain_version(name,
                                                                 cuda):
    """A bisection of 20 ranks: a first pass of 20 equal brackets (the key
    extent) at 2048 thresholds, then a later pass of 20 disjoint brackets
    with the thresholds spread inside them, on every bucket."""
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    R = 20
    keys = _all_keys(name, plan)
    first = np.repeat([[keys[0], keys[-1]]], R, axis=0)
    ends = keys[np.linspace(0, len(keys) - 1, 2 * R).astype(np.int64)]
    bands = ends.reshape(R, 2)
    m = 2046 // R
    inside = np.unique(np.array(
        [int(lo) + (int(hi) - int(lo)) * j // m for lo, hi in bands
         for j in range(m)], ends.dtype))
    for label, thr, br in (
            ("first", _thresholds(plan, 2048, 20), _as_words(plan, first)),
            ("later", _as_words(plan, inside[:2048]), _as_words(plan, bands))):
        for call in engine.key_calls(plan):
            bins, mm = call.rank_pass(thr, br, *kkeys.rank_outputs(
                thr.shape[0], R, plan.bits_dtype, cuda))
            want_bins, want_mm = call.rank_pass_plain(thr, br)
            assert torch.equal(bins, want_bins), (name, label)
            assert torch.equal(mm, want_mm), (name, label)


def _quantile_equal(got, want, dtype) -> bool:
    """Bits, a NaN by isnan, a zero by == (numpy returns either sign)."""
    got, want = np.asarray(got), np.asarray(want).astype(dtype)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    nan = np.isnan(want)
    zero = want == 0
    rest = ~nan & ~zero
    return (np.array_equal(np.isnan(got), nan)
            and bool(np.all(got[zero] == 0))
            and np.array_equal(got[rest].view(f"u{got.itemsize}"),
                               want[rest].view(f"u{want.itemsize}")))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_quantile_on_card_equals_numpy(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    qs = np.array((0, 1e-6, 0.001, 0.1, 0.25, 0.5, 0.75, 0.9, 0.999, 1))
    for method in ("linear", "lower", "higher", "midpoint", "nearest"):
        kkeys.reset_launches()
        got = alp_tpu_torch.query_quantile(col, qs, method)
        assert kkeys.LAUNCHES["rank_pass"] >= engine.LAST_RANK_PASSES >= 1
        assert engine.LAST_RANK_BISECTIONS == 1       # <= 20 ranks
        assert _quantile_equal(got, np.quantile(x, qs, method=method),
                               x.dtype), method
    median = alp_tpu_torch.query_median(col)
    assert type(median) is x.dtype.type
    assert _quantile_equal(median, np.median(x), x.dtype)


# ---------------------------------------------------------------------------
# GROUP-BY, windows, DISTINCT: K18, K19
# ---------------------------------------------------------------------------

def _column_keys(plan, G: int, ordered: bool, seed: int) -> torch.Tensor:
    """int32 [n_vectors, 1024] group ids in column order (the pad -1)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, G, plan.n_values)
    if ordered:
        keys = np.sort(keys)
    kv = np.full(plan.n_vectors * 1024, -1, np.int32)
    kv[:plan.n_values] = keys
    return torch.from_numpy(kv.reshape(-1, 1024)).to(plan.device)


def _sentinel_sums(plan) -> tuple:
    """K18's outputs [n_vectors, W + 3] and [n_vectors, 2] filled with a
    sentinel, not zeros, so that a column K18 leaves unwritten shows."""
    W = kes.WINDOWS[plan.bits_dtype]
    return (torch.full((plan.n_vectors, W + 3), -7, dtype=torch.int64,
                       device=plan.device),
            torch.full((plan.n_vectors, 2), 7, dtype=plan.bits_dtype,
                       device=plan.device))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_group_kernels_equal_plain_versions(name, cuda):
    """K18 on every bucket, K19 on every bucket at G in {1, 16, 300, 65536}
    (shared-memory and device-memory accumulators) with random and sorted
    keys."""
    from alp_tpu_torch.kernels import group as kgroup
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    sums, keys = _sentinel_sums(plan)
    for call in engine.group_calls(plan):
        before = kgroup.LAUNCHES["vector_sum_extremes"]
        call.vector_sums(sums, keys)
        assert kgroup.LAUNCHES["vector_sum_extremes"] == before + 1
        want_sums, want_keys = call.vector_sums_plain()
        assert torch.equal(sums[call.rows], want_sums), name
        assert torch.equal(keys[call.rows], want_keys), name
    for G in (1, 16, 300, 65536):
        for ordered in (False, True):
            kv = _column_keys(plan, G, ordered, G)
            for call in engine.group_calls(plan):
                gk = kv[call.rows].contiguous()
                before = kgroup.LAUNCHES["group_reduce"]
                out, ext = call.group_reduce(gk, G, *kgroup.group_outputs(
                    G, plan.bits_dtype, cuda))
                assert kgroup.LAUNCHES["group_reduce"] == before + 1
                want_out, want_ext = call.group_reduce_plain(gk, G)
                assert torch.equal(out, want_out), (name, G, ordered)
                assert torch.equal(ext, want_ext), (name, G, ordered)


# csrc/group.cu kSharedAcc: K19 keeps G groups in shared memory while
# G * ((2 W + 1) * 4 + 16 + 2 * key bytes) fits (GroupCounters::group_bytes:
# f64 363 groups, f32 2048)
SHARED_ACC_BYTES = 200 * 1024


def _shared_groups(plan) -> int:
    W = kes.WINDOWS[plan.bits_dtype]
    return SHARED_ACC_BYTES // ((2 * W + 1) * 4 + 16 + 2 * (8 if plan.f64
                                                             else 4))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_k19_edges_equal_its_plain_version(name, cuda):
    """K19 on every bucket, bit for bit: G on both sides of the shared /
    device boundary (random ids), every key equal, keys distinct within a
    vector (and across the column), ids at G and above (counted nowhere);
    the columns hold NaN of both signs, +-Inf, -0.0 and a partial last
    vector."""
    from alp_tpu_torch.kernels import group as kgroup
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    rng = np.random.default_rng(19)
    n = plan.n_vectors * 1024
    edge = _shared_groups(plan)
    cases = [(G, rng.integers(0, G, n)) for G in (edge, edge + 1)]
    cases += [(16, np.full(n, 5)), (1, np.zeros(n, np.int64)),
              (1024, np.arange(n) % 1024), (n, np.arange(n)),
              (16, rng.integers(0, 40, n)), (edge + 1, rng.integers(
                  edge - 2, 2 * edge, n))]
    for G, ids in cases:
        kv = torch.from_numpy(ids.astype(np.int32).reshape(-1, 1024)).to(
            cuda)
        for call in engine.group_calls(plan):
            gk = kv[call.rows].contiguous()
            out, ext = call.group_reduce(gk, G, *kgroup.group_outputs(
                G, plan.bits_dtype, cuda))
            want_out, want_ext = call.group_reduce_plain(gk, G)
            assert torch.equal(out, want_out), (name, G)
            assert torch.equal(ext, want_ext), (name, G)


def _k18_edge_columns() -> dict:
    """name -> (column, the scheme of its edge buckets) of K18's edges on
    each route, 2 rowgroups and a partial last vector of 333 values: a
    vector whose every value is an exception (NaN among decimals, tiny
    negatives among normals), a vector whose warps span
    more than two digit windows (huge and subnormal values beside
    moderate ones), NaN of both signs, a signaling NaN, +-Inf and -0.0;
    and a constant column (bit width 0)."""
    rng = np.random.default_rng(18)
    n = 2 * C.N_VECTORS_PER_ROWGROUP * 1024 + 333
    cols = {}
    for dt, ut, huge, tiny, rd_tiny in (
            (np.float64, np.uint64, 1e300, 1e-310, 1e-300),
            (np.float32, np.uint32, 1e30, 1e-41, 1e-41)):
        width = np.dtype(dt).itemsize * 8
        sign = 1 << (width - 1)
        exp = (1 << (width - 1)) - (1 << (23 if width == 32 else 52))
        quiet = 1 << (22 if width == 32 else 51)
        specials = np.array([exp | quiet, sign | exp | quiet, exp | 1,
                             exp, sign | exp, sign, 0], ut).view(dt)
        for scheme, x in (("alp", np.round(rng.uniform(-50, 50, n), 2)),
                          ("rd", rng.standard_normal(n))):
            x = x.astype(dt)
            if scheme == "alp":
                x[5 * 1024:6 * 1024] = np.nan
            else:                            # as _edge_columns
                x[3 * 1024:4 * 1024] = (-np.abs(rng.standard_normal(1024))
                                        * rd_tiny).astype(dt)
            wide = x[7 * 1024:8 * 1024]
            wide[::3] = (rng.standard_normal(342) * huge).astype(dt)
            wide[1::5] = (rng.standard_normal(205) * tiny).astype(dt)
            x[9 * 1024:9 * 1024 + 8 * len(specials)] = np.tile(specials, 8)
            cols[f"{scheme}_f{width}"] = (x, scheme)
    cols["constant_tail"] = (np.full(n, -7.25), "alp")
    return cols


K18_EDGES = _k18_edge_columns()


def _permuted_call(call, seed: int):
    """The bucket of ``call`` with its rows in a random order."""
    per_row = (0, 2, 3, 4, 5) if call.scheme == "alp" else (0, 2, 4, 5, 6)
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(len(call.rows), generator=g).to(call.rows.device)
    args = tuple(a[perm].contiguous() if j in per_row else a
                 for j, a in enumerate(call.args))
    return engine.KeyCall(call.scheme, args, call.rows[perm].contiguous(),
                          call.bw)


@pytest.mark.parametrize("name", sorted(K18_EDGES))
def test_k18_edges_equal_its_plain_version(name, cuda):
    """K18 on every bucket of each route's edge column, and with each
    bucket's rows permuted, bit for bit, into outputs filled with a
    sentinel (every column and both keys of a row written, no other row
    touched); then the column's whole rowgroups tiled to 4096 vectors,
    more rows than blocks can be resident on the card (at most 8 blocks of
    256 threads an SM), so that a block walks many rows."""
    from alp_tpu_torch.columns import tile_column
    x, scheme = K18_EDGES[name]
    whole = len(x) - len(x) % (C.N_VECTORS_PER_ROWGROUP * 1024)
    col = alp_tpu_torch.compress(x)
    if name != "constant_tail":
        assert int((np.asarray(col.exc_count) == 1024).sum()) >= 1, name
    tiled = tile_column(alp_tpu_torch.compress(x[:whole]), 4096)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tiled.n_vectors > 8 * n_sm
    for c in (col, tiled):
        plan = c.plan(cuda)
        calls = engine.group_calls(plan)
        assert scheme in {call.scheme for call in calls}, name
        if name == "constant_tail":
            assert {call.bw for call in calls} == {0}
        calls += [_permuted_call(call, s) for s, call in enumerate(calls)]
        for call in calls:
            sums, keys = _sentinel_sums(plan)
            call.vector_sums(sums, keys)
            want_sums, want_keys = call.vector_sums_plain()
            assert torch.equal(sums[call.rows], want_sums), (name, call.bw)
            assert torch.equal(keys[call.rows], want_keys), (name, call.bw)
            others = torch.ones(plan.n_vectors, dtype=torch.bool,
                                device=cuda)
            others[call.rows] = False
            assert bool((sums[others] == -7).all()), name
            assert bool((keys[others] == 7).all()), name


def test_group_in_runs_on_the_card(cuda):
    """A group whose values span several runs of K19 is summed exactly:
    the runs add up to the one-run totals."""
    x = COLUMNS["f64_mixed_alp_rd"]
    plan = alp_tpu_torch.compress(x).plan(cuda)
    kv = _column_keys(plan, 3, False, 3)
    outs, ext = engine.group_reduce(plan, kv, 3)
    runs, ext2 = engine.group_reduce(plan, kv, 3, run_values=7 * 1024 + 1)
    assert len(outs) == 1 and len(runs) > 1
    assert torch.equal(sum(runs), outs[0]) and torch.equal(ext2, ext)


def _same_groups(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        _same_array(np.asarray(a[k]), np.asarray(b[k])) for k in a)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_group_queries_on_card_equal_cpu(name, cuda):
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    rng = np.random.default_rng(16)
    for G, keys in ((16, rng.integers(0, 16, len(x))),
                    (1000, np.sort(rng.integers(0, 1000, len(x))))):
        assert _same_groups(
            alp_tpu_torch.query_groupby(col, keys, G),
            alp_tpu_torch.query_groupby(col, keys, G, device="cpu"))
    for window, hop in ((100000, None), (102400, None), (4096, 1024)):
        assert _same_groups(
            alp_tpu_torch.query_window(col, window, hop=hop),
            alp_tpu_torch.query_window(col, window, hop=hop, device="cpu"))
    assert alp_tpu_torch.query_distinct(col) == \
        alp_tpu_torch.query_distinct(col, device="cpu")


def test_group_queries_never_take_the_plain_versions(cuda, monkeypatch):
    from alp_tpu_torch.kernels import group as kgroup

    def refuse(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")
    for name in ("sums_of_bits", "groups_of_bits", "vector_sums_alp_plain",
                 "vector_sums_rd_plain", "group_reduce_alp_plain",
                 "group_reduce_rd_plain"):
        monkeypatch.setattr(kgroup, name, refuse)
    monkeypatch.setattr(kgroup, "_PLAIN", {
        k: (v[0], refuse, refuse) for k, v in kgroup._PLAIN.items()})
    x = COLUMNS["f64_mixed_alp_rd"]
    col = alp_tpu_torch.compress(x)
    kgroup.reset_launches()
    keys = np.arange(len(x)) % 7
    got = alp_tpu_torch.query_groupby(col, keys, 7)
    assert got["count"].tolist() == np.bincount(keys).tolist()
    got = alp_tpu_torch.query_window(col, 100000)
    assert _same(float(got["sum"][0]), _fsum(x[:100000]))
    assert kgroup.LAUNCHES["vector_sum_extremes"] and \
        kgroup.LAUNCHES["group_reduce"], kgroup.LAUNCHES


def _ieee_sum(part: np.ndarray) -> float:
    """A group's SUM by IEEE's rules: NaN for a NaN or +Inf with -Inf, an
    infinity, else ``math.fsum``."""
    pinf, ninf = bool(np.isposinf(part).any()), bool(np.isneginf(part).any())
    if np.isnan(part).any() or (pinf and ninf):
        return math.nan
    if pinf or ninf:
        return math.inf if pinf else -math.inf
    return math.fsum(part.tolist())


@pytest.mark.parametrize("dense", [True, False], ids=["alp_rd", "alp"])
def test_f3_special_groups_beside_an_overflowing_sum_on_card(cuda, dense):
    """Fault F3: a group or window with NaN or an infinity beside finite
    values past DBL_MAX answers NaN or the infinity on the card, as on the
    CPU, and never raises."""
    import torch_parallel_worker as worker

    n = 4 * 1024 + 500
    kinds = [worker.F3_KINDS[g % 5] for g in range(300)]
    for G in (1, 5, 300):
        keys = np.random.default_rng(G).integers(0, G, n)
        x = worker.f3_column(keys, ["nan"] if G == 1 else kinds[:G], dense,
                             G)
        col = alp_tpu_torch.compress(x)
        got = alp_tpu_torch.query_groupby(col, keys, G)
        assert _same_groups(got, alp_tpu_torch.query_groupby(
            col, keys, G, device="cpu"))
        for g in range(G):
            assert _same(float(got["sum"][g]), _ieee_sum(x[keys == g]))
    for window, hop in ((1000, None), (1000, 250)):
        x = worker.f3_column(np.arange(n) // (hop or window), kinds, dense, 7)
        col = alp_tpu_torch.compress(x)
        got = alp_tpu_torch.query_window(col, window, hop=hop)
        assert _same_groups(got, alp_tpu_torch.query_window(
            col, window, hop=hop, device="cpu"))
        step = hop or window
        for i, s in enumerate(range(0, n - window + step, step)):
            assert _same(float(got["sum"][i]), _ieee_sum(x[s:s + window]))


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_distinct_in_chunks_on_card(name, cuda, monkeypatch):
    """DISTINCT sorts DISTINCT_CHUNK values at a time and counts a chunk's
    keys that no earlier chunk holds: in one chunk and in small ones it
    equals numpy's count (-0.0 equal to 0.0, every NaN one value)."""
    x = COLUMNS[name]
    want = len(np.unique(x[~np.isnan(x)])) + int(np.isnan(x).any())
    col = alp_tpu_torch.compress(x)
    assert alp_tpu_torch.query_distinct(col) == want
    for chunk in (3000, 1 << 16):
        monkeypatch.setattr(engine, "DISTINCT_CHUNK", chunk)
        assert alp_tpu_torch.query_distinct(col) == want


# ---------------------------------------------------------------------------
# The bench's kernels K20-K23 and the loop steps
# ---------------------------------------------------------------------------

def _left_parts(bits: torch.Tensor, rbw: int) -> torch.Tensor:
    """The left part above the low ``rbw`` bits of each pattern, int32."""
    S = 8 * bits.element_size()
    u = bits.to(torch.int64) & ((1 << S) - 1 if S < 64 else -1)
    left = (u >> rbw) & ((1 << (S - rbw)) - 1) if rbw else u
    return left.to(torch.int32) if S == 64 else \
        torch.where(left >= 1 << 31, left - (1 << 32), left).to(torch.int32)


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_bench_kernels_equal_plain_versions(name, cuda):
    """K20 and K22 on every ALP bucket, K21 on every ALP_RD bucket (its
    left parts from the full decode, so it gives the decode back) and K23
    on the decoded bits of every f64 column, against their plain versions
    by bits."""
    from alp_tpu_torch.kernels import group as kgroup
    from alp_tpu_torch.ops.fastlanes import unffor_unpack
    plan = decode.build_plan(alp_tpu_torch.compress(COLUMNS[name]), cuda)
    bits = plan.run().view(_bits_dtype(plan))
    for b in plan.buckets:
        if b.scheme == C.SCHEME_ALP:
            before = kffor.LAUNCHES["unffor"]
            got = kffor.unffor(b.args[0], b.bw, b.args[1])
            assert kffor.LAUNCHES["unffor"] == before + 1
            assert torch.equal(got, unffor_unpack(b.args[0], b.args[1], b.bw))
            if plan.f64:
                before = falp.LAUNCHES["variant_sum_f64"]
                got = falp.variant_sum_f64(b.args[0], b.bw, *b.args[1:])
                assert falp.LAUNCHES["variant_sum_f64"] == before + 1
                want = falp.variant_sum_plain(b.args[0], b.bw, *b.args[1:])
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))
            continue
        fn = falp.rd_glue_f64 if plan.f64 else falp.rd_glue_f32
        want = bits[b.rows]
        left = _left_parts(want, b.bw)
        got = fn(b.args[0], b.bw, left)
        assert torch.equal(got, want)
        assert torch.equal(got, falp.rd_glue_plain(b.args[0], b.bw, left))
    if plan.f64:
        before = kgroup.LAUNCHES["key_extremes_bits"]
        got = kgroup.key_extremes_bits_f64(bits)
        assert kgroup.LAUNCHES["key_extremes_bits"] == before + 1
        assert torch.equal(got, kgroup.key_extremes_bits_plain(bits))
    torch.cuda.synchronize()


@pytest.mark.parametrize("bw", range(65))
def test_k20_every_bit_width(cuda, bw):
    """K20 at every bit width on seeded random words, bases and factors
    whose products wrap, and 37 vectors (not a multiple of a block's 16),
    against its plain version by bits."""
    g = torch.Generator(device=cuda).manual_seed(bw)
    n = 37
    info = torch.iinfo(torch.int64)

    def words(*shape):
        return torch.empty(shape, dtype=torch.int64, device=cuda).random_(
            info.min, info.max, generator=g)

    packed, base, fact = words(n, bw * 16), words(n), words(n)
    frac = torch.pow(10.0, -torch.randint(0, 21, (n,), generator=g,
                                          device=cuda).double())
    before = falp.LAUNCHES["variant_sum_f64"]
    got = falp.variant_sum_f64(packed, bw, base, fact, frac)
    assert falp.LAUNCHES["variant_sum_f64"] == before + 1
    want = falp.variant_sum_plain(packed, bw, base, fact, frac)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), bw


@pytest.mark.parametrize("S,rbw", [(64, 48), (64, 52), (64, 64), (32, 0),
                                   (32, 24), (32, 32)])
def test_k21_on_random_bits(cuda, S, rbw):
    g = torch.Generator(device=cuda).manual_seed(S + rbw)
    dt = torch.int64 if S == 64 else torch.int32
    info = torch.iinfo(dt)
    right = torch.empty((37, rbw * 1024 // S), dtype=dt, device=cuda).random_(
        info.min, info.max, generator=g)
    left = torch.empty((37, 1024), dtype=torch.int32, device=cuda).random_(
        -2**31, 2**31 - 1, generator=g)
    fn = falp.rd_glue_f64 if S == 64 else falp.rd_glue_f32
    assert torch.equal(fn(right, rbw, left),
                       falp.rd_glue_plain(right, rbw, left))


@pytest.mark.parametrize("name", ["bench_bw30_bitcoin", "f32_alp",
                                  "f64_mixed_alp_rd", "f64_specials_tail"])
def test_loop_steps_on_card_equal_queries(name, cuda):
    """Each step at carry 0 on the card against the port's query answers
    on the card; K20 runs in the sum step of an f64 ALP column; every step
    takes a carry and loop_bench times it."""
    from alp_tpu_torch import benchlib
    x = COLUMNS[name]
    col = alp_tpu_torch.compress(x)
    plan = col.plan(cuda)
    zero = torch.zeros((), dtype=torch.int64, device=cuda)
    before = falp.LAUNCHES["variant_sum_f64"]
    step, args = engine.make_sum_step(plan)
    parts = step.result(zero, *args)
    if plan.f64 and any(b.scheme == C.SCHEME_ALP and b.bw
                        for b in plan.buckets):
        assert falp.LAUNCHES["variant_sum_f64"] > before
    for b, part in zip(plan.buckets, parts):
        if plan.f64 and b.scheme == C.SCHEME_ALP and b.bw:
            want = falp.variant_sum_plain(b.args[0], b.bw, *b.args[1:])
            assert torch.equal(part.view(torch.int32), want.view(torch.int32))
    step, args = engine.make_exact_sum_step(plan)
    assert torch.equal(step.result(zero, *args),
                       engine.exact_sum_totals(plan))
    fin = np.sort(x[np.isfinite(x)])
    lo, hi = float(fin[len(fin) // 4]), float(fin[3 * len(fin) // 4])
    step, args = engine.make_filter_step(plan, lo, hi)
    assert step.answer(step.result(zero, *args)) == \
        alp_tpu_torch.query_filter_count(col, lo, hi)
    edges = np.linspace(fin[0], fin[-1], 17).tolist()
    step, args = engine.make_histogram_step(plan, edges)
    assert np.array_equal(step.answer(step.result(zero, *args)),
                          alp_tpu_torch.query_histogram(col, edges))
    t, bins = engine.make_topk_step(plan, 5)[0].result(zero, plan)
    assert t.device == bins.device == plan.device
    keys = np.sort(np.random.default_rng(9).integers(0, 7, len(x)))
    for k in (keys, np.random.default_rng(9).integers(0, 7, len(x))):
        step, args = engine.make_groupby_step(col, k, 7, plan=plan)
        got = step.answer(step.result(zero, *args))
        want = engine.group_totals(col, k, 7)
        assert got.totals == want.totals and np.array_equal(got.ct, want.ct)
        assert np.array_equal(got.kmn, want.kmn) and \
            np.array_equal(got.kmx, want.kmx)
    for make in (engine.make_sum_step, engine.make_exact_sum_step):
        assert benchlib.loop_bench(*make(plan), 3) > 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_snapshot_round_trip_on_card(name, cuda):
    """A kept plan (its key extent and K18 totals kept) through
    ``plan_store.snapshot`` and ``restore`` on the card: every view 256-byte
    aligned, and the decode, SUM totals, K15 bins, key extent and vector
    sums equal to the built plan's."""
    from alp_tpu_torch import plan_store
    col = alp_tpu_torch.compress(COLUMNS[name])
    plan = col.plan(cuda)
    engine._plan_key_extent(plan)
    engine._plan_vector_sums(plan)
    restored = plan_store.restore(plan_store.snapshot(plan))
    assert restored.device.type == "cuda"
    for b in restored.buckets:
        for t in (b.rows, *b.args):
            assert t.is_cuda and (not t.numel() or t.data_ptr() % 256 == 0)
    bits = _bits_dtype(plan)
    assert torch.equal(restored.run().view(bits), plan.run().view(bits))
    assert torch.equal(engine.exact_sum_totals(restored),
                       engine.exact_sum_totals(plan))
    x = COLUMNS[name]
    fin = np.sort(x[np.isfinite(x)])
    thr = np.unique(engine._float_keys(fin[::max(1, len(fin) // 16)],
                                       x.dtype))
    assert torch.equal(engine.key_count_bins(restored, thr),
                       engine.key_count_bins(plan, thr))
    assert restored.key_extent == plan.key_extent
    for a, b in zip(restored.vector_sums, plan.vector_sums):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_on_cards(world, cuda, tmp_path):
    """The sharded paths over NCCL, a rank a card
    (``torch_parallel_worker``): every rank's blob equals host compress's,
    its decode (on its own card) the input's bits, its SUM ``math.fsum``, its
    COUNT and GROUP-BY the single-device answers, its encode step the
    plain versions' choice, and its join of SUM rows near 2^62 their
    Python-integer sum."""
    import torch_parallel_worker as worker
    from alp_tpu_torch import device_compress as dc
    from alp_tpu_torch.kernels import _build
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} NVIDIA GPUs")
    _build.build()
    ranks = worker.spawn_ranks(world, "cuda", str(tmp_path))
    cpu = torch.device("cpu")
    for name, x in worker.columns().items():
        col = alp_tpu_torch.compress(x)
        keys = worker.group_keys(len(x))
        groups = alp_tpu_torch.query_groupby(col, keys, worker.GROUPS,
                                             device=cpu)
        count = alp_tpu_torch.query_filter_count(col, *worker.COUNT_RANGE,
                                                 device=cpu)
        for r in ranks:
            assert r["blob"][name] == col.to_bytes()
            assert r["decoded"][name] == (f"cuda:{r['rank']}", x.tobytes())
            assert r["shards"][name] == x.tobytes()
            assert _same(r["sum"][name], worker.fsum_reference(x))
            assert r["count"][name] == count
            for agg, want in groups.items():
                assert r["groupby"][name][agg].tobytes() == want.tobytes()
    values, combos, k_count = worker.step_problem()
    v = torch.from_numpy(values)
    fac, exp = dc._second_level(v[:, ::32].contiguous(),
                                torch.from_numpy(combos),
                                torch.from_numpy(k_count), True)
    ints, _, *stats = kenc.alp_encode_f64(v, exp, fac, stats=True)
    bw, base, _, n_exc, _ = dc.finalize_encode_stats(ints, *stats)
    width = kes.WINDOWS[torch.int64] + 3
    rows = np.concatenate([worker.join_rows(r, width) for r in range(world)])
    total = sum(int(t) << (32 * w) for row in rows.tolist()
                for w, t in enumerate(row[:width - 3]))
    for r in ranks:
        step = r["step"]
        for key, want in (("fac", fac), ("exp", exp), ("bit_width", bw),
                          ("base", base), ("exc_count", n_exc)):
            assert np.array_equal(step[key].astype(np.int64),
                                  want.numpy().astype(np.int64)), key
        assert step["ok"].all()
        assert r["join"][0] == total


def _step_column(multi: bool) -> np.ndarray:
    """Three rowgroups of decimals: each rowgroup keeps one pair, or (with
    ``multi``) three, its sampled vectors taking three precisions."""
    rng = np.random.default_rng(21)
    n = 3 * C.N_VECTORS_PER_ROWGROUP * C.VECTOR_SIZE
    x = np.round(rng.uniform(-20, 180, n), 1)
    if multi:
        turn = np.arange(n) // C.VECTOR_SIZE // 12 % 3
        x[turn == 1] = np.round(rng.uniform(0, 100, int((turn == 1).sum())),
                                4)
        x[turn == 2] = np.round(rng.uniform(0, 1e4, int((turn == 2).sum())),
                                1)
    return x


@pytest.mark.parametrize("multi,k_max", [(False, 1), (False, 5), (True, 5)])
def test_device_compress_steps_on_card_equal_compress_device(multi, k_max,
                                                             cuda):
    """``make_device_compress_step`` and ``make_pack_step`` at carry 0 on
    the card: the per-vector metadata and the packed words of
    ``compress_device`` (and of host compress), K9-K11 launched; the
    steps leave their inputs as they were under ``loop_bench``."""
    from alp_tpu_torch import benchlib
    from alp_tpu_torch import device_compress as dc
    x = _step_column(multi)
    values = torch.from_numpy(x.reshape(-1, C.VECTOR_SIZE).copy()).to(cuda)
    want = alp_tpu_torch.compress_device(values=values)
    assert want.to_bytes() == alp_tpu_torch.compress(x).to_bytes()
    zero = torch.zeros((), dtype=torch.int64, device=cuda)
    before = {**kscore.LAUNCHES, **kenc.LAUNCHES, **kffor.LAUNCHES}
    step, args = dc.make_device_compress_step(values, k_max)
    meta = step.result(zero, *args)
    for field in ("fac", "exp", "bit_width", "base", "exc_count"):
        assert np.array_equal(getattr(meta, field).cpu().numpy(),
                              getattr(want, field).astype(np.int64)), field
    pack, pack_args = dc.make_pack_step(want, values)
    words = np.concatenate(want.packed)
    assert np.array_equal(
        pack.result(zero, *pack_args).cpu().numpy().view(np.uint64), words)
    after = {**kscore.LAUNCHES, **kenc.LAUNCHES, **kffor.LAUNCHES}
    for k in ("score_pairs_f64", "alp_encode_f64", "ffor_pack_f64"):
        assert after[k] > before[k], k
    assert benchlib.loop_bench(step, args, 3) > 0
    assert benchlib.loop_bench(pack, pack_args, 3) > 0
    assert np.array_equal(values.cpu().numpy().reshape(-1), x)
    assert np.array_equal(
        pack.result(zero, *pack_args).cpu().numpy().view(np.uint64), words)


@pytest.mark.parametrize("codec", ["gorillas", "chimp", "chimp128", "patas",
                                   "pde"])
def test_native_competitor_round_trip(codec, cuda):
    """The competitor codecs of ``native/competitors.cpp``, built by the
    port's loader on the card's host: chunked encode and decode at 1 and 8
    threads give the input's bits back (PDE with its patches)."""
    from alp_tpu_torch import native
    x = np.concatenate([_step_column(False)[:50000],
                        np.random.default_rng(2).standard_normal(20000)])
    bits = x.view(np.uint64)
    for threads in (1, 8):
        flat, off, words, ns = native.competitor_encode_chunked(
            codec, x, 10240, threads)
        streams = [flat[off[c]:off[c] + words[c]].copy()
                   for c in range(len(ns))]
        out = np.zeros(len(x), np.uint64)
        native.competitor_decode_chunked(codec, streams, ns, out, threads)
        if codec == "pde":
            for c, s in enumerate(streams):
                n, at = int(ns[c]), c * 10240
                exp = s[(n + 1) // 2:].view(np.uint8)[:n]
                sel = exp == native.PDE_EXCEPTION
                out[at:at + n][sel] = bits[at:at + n][sel]
        assert np.array_equal(out, bits)
        if codec != "pde":
            stream, _ = native.competitor_encode(codec, x)
            assert np.array_equal(
                native.competitor_decode(codec, stream, len(x)).view(
                    np.uint64), bits)
