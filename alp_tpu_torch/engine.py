"""The query engine over a compressed column on a device.

Counterpart of ``alp_tpu/engine.py``'s queries.  Every answer equals the
JAX package's bit for bit.

* ``query_sum`` / ``query_mean`` (exact, K5-K8) and ``query_filter_sum``
  (the same kernels with a key range);
* ``query_filter_count``, ``query_min`` / ``query_max``, ``query_topk``
  and ``query_histogram`` over the IEEE-754 total-order keys of the
  values, through K15 ``key_counts`` (prefix counts of keys at given
  thresholds) and K16 ``key_extremes`` (each vector's least and largest
  key), both fused with the decode;
* ``query_quantile`` / ``query_median``, exact rank selection: a
  bisection over the total-order keys whose passes are K17 ``rank_pass``
  (K15's prefix counts at many probe keys plus, for each rank, the least
  and the largest key inside its bracket), then numpy's interpolation;
* ``query_groupby`` / ``query_window`` (exact per-group SUM, MEAN,
  COUNT, MIN, MAX): keys in order through K18 ``vector_sum_extremes``
  (each vector's exact-SUM totals and key extremes, kept on the plan), an
  int64 prefix sum over the vectors and K19 ``group_reduce`` on the
  vectors a group boundary crosses; any other keys through K19 over the
  whole column; ``query_distinct`` (the decode, keys and ``torch.sort``)
  and ``groupby_keys``;
* ``query_scan`` (the full decode), ``query_count_exceptions`` and
  ``query_compression``, thin wrappers.

Keys: -0.0 counts as +0.0, and bounds are rounded to the column dtype
first (``_float_key``), so an f32 column compares against ``f32(lo)``.
The kernels write each vector's exceptions in from the plan's per-vector
CSRs and skip the pad of a partial last vector, so no host correction is
left (the JAX package's ``_pred_corrections`` and its kin have no
counterpart).

The SUM.  A finite value is ``m' * 2^(e_eff - B)`` (B =
1075 for f64, 150 for f32); the kernels add the signed 32-bit digits of
the integer ``m' << e_eff`` into int64 windows over the whole exponent
range and count NaN, +Inf and -Inf apart.  The host joins the windows
with Python integers and rounds once, so ``query_sum`` equals
``math.fsum`` bit for bit and ``query_mean`` is the exact rational
``sum / n`` rounded once.

Per column, ``exact_sum_totals(plan)`` runs on the plan's device:

* every ALP bucket goes through K7/K8, the decode fused with the sum; the
  kernel writes each vector's true exception bits in and skips the pad of
  a partial last vector, so no decoded value reaches device memory and no
  correction is left for the host;
* the ALP_RD buckets decode with K3/K4 into one compact scratch, their
  exceptions are scattered in, and K5/K6 sum the scratch.

The kernels add into int64 ``[W + 3]`` totals, one for each run of fewer
than 2^31 values (one run for any column below that size), which cross to
the host once; the host joins the runs as Python integers, so a column
has no size limit of its own.  The plan comes from
``CompressedColumn.plan(device)``, built at the first query and kept, as
the JAX package keeps its own.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from fractions import Fraction

import numpy as np
import torch

from . import constants as C
from . import tracing
from .kernels import exact_sum as kes
from .kernels import group as kgroup
from .kernels import keys as kkeys
from .kernels.decode import VECTOR_SIZE, resolve_device
from .ops.keys import bias, biased_keys

# value dtype -> B, the power of two of the fixed-point scale
_SCALE = {np.dtype(np.float64): 1075, np.dtype(np.float32): 150}


@tracing.spanned("alp.engine.query_sum")
def query_sum(col, device=None) -> float:
    """SUM(column), correctly rounded: bit-identical to ``math.fsum`` of
    the column's values.  NaN, or +Inf with -Inf, gives NaN; an empty
    column gives 0.0.  ``device=None`` means ``"cuda"`` and raises when no
    card is present; ``device="cpu"`` runs the kernels' plain versions."""
    dev = resolve_device(device)
    if col.n_values == 0:
        return 0.0
    rows = _sum_rows(col, dev)
    with tracing.span("alp.engine.sum.join"):
        return _finish_sum(*join_totals(rows, col.dtype))


@tracing.spanned("alp.engine.query_mean")
def query_mean(col, device=None) -> float:
    """MEAN(column), correctly rounded: the exact rational ``sum / n``
    rounded once (one rounding fewer than ``math.fsum(x) / n``).  An empty
    column gives NaN."""
    dev = resolve_device(device)
    if col.n_values == 0:
        return float("nan")
    rows = _sum_rows(col, dev)
    with tracing.span("alp.engine.sum.join"):
        total, nan_c, pinf, ninf, scale = join_totals(rows, col.dtype)
        if nan_c or pinf or ninf:
            return _finish_sum(total, nan_c, pinf, ninf, scale)
        if total == 0:
            return 0.0
        return float(Fraction(total, col.n_values << scale))


@dataclasses.dataclass(frozen=True)
class SumCall:
    """One SUM kernel call of a plan: the kernel's name (a key of
    ``exact_sum.LAUNCHES``), its wrapper's positional arguments, the real
    vector id of each row it sums, the bit width of its packed words (0
    for decoded bits), and the key range it filters by (None: every
    value)."""
    kernel: str
    args: tuple
    rows: torch.Tensor
    bw: int
    key_range: tuple | None = None

    def launch(self, out: torch.Tensor) -> torch.Tensor:
        """The kernel (or, on a CPU tensor, its plain version) added into
        ``out``."""
        return kes.KERNELS[self.kernel][0](*self.args, out=out,
                                           key_range=self.key_range)

    def plain(self) -> torch.Tensor:
        """The plain version's totals on the same arguments."""
        return kes.KERNELS[self.kernel][1](*self.args, self.key_range)

    def split(self, max_rows: int) -> list:
        """The call cut into calls of at most ``max_rows`` rows each (its
        per-row arguments sliced; the rest shared)."""
        n = self.rows.shape[0]
        if n <= max_rows:
            return [self]
        per_row = _PER_ROW_ARGS[self.kernel]
        return [SumCall(self.kernel,
                        tuple(a[lo:lo + max_rows] if i in per_row else a
                              for i, a in enumerate(self.args)),
                        self.rows[lo:lo + max_rows], self.bw,
                        self.key_range)
                for lo in range(0, n, max_rows)]


# kernel -> positions of its row-indexed arguments: K5/K6 (bits, vec, ...),
# K7/K8 (packed, bw, base, fact, frac, rows, ...)
_PER_ROW_ARGS = {"exact_sum_f64": (0, 1), "exact_sum_f32": (0, 1),
                 "falp_decode_f64_exact_sum": (0, 2, 3, 4, 5),
                 "falp_decode_f32_exact_sum": (0, 2, 3, 4, 5)}


def sum_calls(plan, key_range=None) -> list:
    """The SUM kernel calls of a plan, in launch order: K7/K8 for each ALP
    bucket, then K5/K6 over the ALP_RD vectors, which this decodes (K3/K4)
    into the plan's compact scratch.  With ``key_range=(klo, khi)``
    (unsigned keys) each sums only the values whose key lies in it."""
    width = "f64" if plan.f64 else "f32"
    calls = [SumCall(f"falp_decode_{width}_exact_sum",
                     (b.args[0], b.bw, *b.args[1:], b.rows, plan.exc_ptr,
                      plan.exc_index, plan.exc_bits, plan.n_values),
                     b.rows, b.bw, key_range)
             for b in plan.buckets if b.scheme == C.SCHEME_ALP]
    if any(b.scheme == C.SCHEME_ALP_RD for b in plan.buckets):
        scratch, vec = plan.decode_rd()
        calls.append(SumCall(f"exact_sum_{width}",
                             (scratch, vec, plan.n_values), vec, 0,
                             key_range))
    return calls


def exact_sum_totals(plan, run_values: int = kes.MAX_VALUES,
                     key_range=None) -> torch.Tensor:
    """The steady-state device part of the SUM: the int64 [runs, W + 3]
    totals of a plan (W windows, then the NaN, +Inf and -Inf counts), on
    the plan's device, with no host join and no synchronise.  Each row is
    the total of a run of fewer than ``run_values`` values (whole vectors,
    pad included), so no int64 total can overflow; a column of fewer than
    2^31 values has one row.  The rows add up as integers
    (``join_totals``).  ``key_range``: only the values whose key lies in
    it (``query_filter_sum``)."""
    max_rows = max(1, (run_values - 1) // VECTOR_SIZE)
    runs = [kes.totals(plan.bits_dtype, plan.device)]
    used = 0
    for call in sum_calls(plan, key_range):
        for part in call.split(max_rows):
            n = part.rows.shape[0]
            if used + n > max_rows:
                runs.append(kes.totals(plan.bits_dtype, plan.device))
                used = 0
            part.launch(runs[-1])
            used += n
    return torch.stack(runs)


def join_totals(totals: list, dtype) -> tuple:
    """(total_int, nan, pinf, ninf, B): the host join of a column's totals
    (``exact_sum_totals(plan).tolist()``, or one total row), ``total_int =
    sum over rows and w of totals[r][w] << 32 w`` = the column's exact sum
    times 2^B."""
    rows = totals if totals and isinstance(totals[0], list) else [totals]
    W = len(rows[0]) - 3
    total = sum(int(t) << (32 * w) for row in rows
                for w, t in enumerate(row[:W]) if t)
    counts = [sum(int(row[W + i]) for row in rows) for i in range(3)]
    return (total, *counts, _SCALE[np.dtype(dtype)])


def _sum_rows(col, dev) -> list:
    """The column's SUM totals, fetched: ``exact_sum_totals(plan)`` as
    lists, for ``join_totals``."""
    totals = exact_sum_totals(col.plan(dev))
    with tracing.span("alp.fetch.sum.totals"):
        return totals.tolist()


def _finish_sum(total: int, nan_c: int, pinf: int, ninf: int,
                scale: int) -> float:
    """Round the exact sum ``total / 2^scale`` once (engine.py:117-128)."""
    if nan_c or (pinf and ninf):
        return float("nan")
    if pinf:
        return float("inf")
    if ninf:
        return float("-inf")
    if total == 0:
        return 0.0
    return float(Fraction(total, 1 << scale))


def _f64_fixed(bits: int):
    """Host mirror of one f64 value's contribution: (signed ``m' <<
    e_eff``, class), class 0 finite, 1 NaN, 2 +Inf, 3 -Inf."""
    e = (bits >> 52) & 0x7FF
    m = bits & ((1 << 52) - 1)
    s = bits >> 63
    if e == 2047:
        return 0, (1 if m else (3 if s else 2))
    v = (m | (1 << 52) if e else m) << max(e, 1)
    return (-v if s else v), 0


def _f32_fixed(bits: int):
    """f32 twin of :func:`_f64_fixed` (scale 2^-150)."""
    e = (bits >> 23) & 0xFF
    m = bits & ((1 << 23) - 1)
    s = bits >> 31
    if e == 255:
        return 0, (1 if m else (3 if s else 2))
    v = (m | (1 << 23) if e else m) << max(e, 1)
    return (-v if s else v), 0


def host_sum_raw(values: np.ndarray) -> tuple:
    """(total_int, nan, pinf, ninf, B) of a host array through the
    per-value mirror: the reference the tests hold the windows against."""
    values = np.ascontiguousarray(values)
    f64 = values.dtype == np.float64
    fixed = _f64_fixed if f64 else _f32_fixed
    total, counts = 0, [0, 0, 0, 0]
    for b in values.view(np.uint64 if f64 else np.uint32).tolist():
        v, cls = fixed(b)
        total += v
        counts[cls] += 1
    return total, counts[1], counts[2], counts[3], _SCALE[values.dtype]


# ---------------------------------------------------------------------------
# Predicate and order queries: total-order keys, K15 and K16
# ---------------------------------------------------------------------------

def _key_type(dtype):
    return np.uint64 if np.dtype(dtype) == np.float64 else np.uint32


def _float_key(v: float, dtype) -> int:
    """The total-order key of a float, rounded to ``dtype`` first (inverse
    of :func:`_key_float`); -0.0 takes +0.0's key, so bounds behave like
    IEEE compares at zero (``alp_tpu/engine.py:1312``)."""
    if np.dtype(dtype) == np.float64:
        b = int(np.float64(v).view(np.uint64))
        if b == 1 << 63:
            b = 0
        return (~b) & ((1 << 64) - 1) if b >> 63 else b | (1 << 63)
    b = int(np.float32(v).view(np.uint32))
    if b == 1 << 31:
        b = 0
    return (~b) & ((1 << 32) - 1) if b >> 31 else b | (1 << 31)


def _float_keys(values, dtype) -> np.ndarray:
    """``[_float_key(v, dtype) for v in values]`` as unsigned numpy keys."""
    ut = _key_type(dtype)
    b = np.asarray(values, np.float64).astype(dtype).view(ut)
    sbit = ut(1) << ut(8 * b.itemsize - 1)
    b = np.where(b == sbit, ut(0), b)
    return np.where((b & sbit) != 0, ~b, b | sbit)


def _key_float(k: int, dtype) -> float:
    """The float of a total-order key (a Python float, also for f32)."""
    if np.dtype(dtype) == np.float64:
        b = (k ^ (1 << 63)) if k >> 63 else (~k) & ((1 << 64) - 1)
        return float(np.uint64(b).view(np.float64))
    b = (k ^ (1 << 31)) if k >> 31 else (~k) & ((1 << 32) - 1)
    return float(np.uint32(b).view(np.float32))


def _pred_key(bits: np.ndarray, klo: int, khi: int) -> np.ndarray:
    """Host mirror of the kernels' predicate on f64/f32 bit patterns
    (unsigned numpy words): total-order key in [klo, khi], -0.0 as +0.0."""
    ut = bits.dtype.type
    sbit = ut(1) << ut(bits.dtype.itemsize * 8 - 1)
    b = np.where(bits == sbit, ut(0), bits)
    key = np.where((b & sbit) != 0, ~b, b | sbit)
    return (key >= ut(klo)) & (key <= ut(khi))


def _keys_to_values(keys: np.ndarray, dtype) -> np.ndarray:
    """Unsigned total-order keys -> values of ``dtype``, as
    ``np.array([_key_float(k, dtype) for k in keys], dtype)`` gives them:
    an f32 value passes through a Python float, so a signaling NaN comes
    out quiet, as in the JAX package's TOP-K."""
    ut = keys.dtype.type
    sbit = ut(1) << ut(keys.dtype.itemsize * 8 - 1)
    bits = np.where((keys & sbit) != 0, keys ^ sbit, ~keys)
    if np.dtype(dtype) == np.float64:
        return bits.view(np.float64)
    return bits.view(np.float32).astype(np.float64).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class KeyCall:
    """The key kernels' arguments for one bucket of a plan: its scheme
    (``"alp"`` or ``"rd"``, a key of ``keys.KERNELS``), the wrappers'
    positional arguments up to ``n_values``, the bucket's vector ids and
    bit width."""
    scheme: str
    args: tuple
    rows: torch.Tensor
    bw: int

    def counts(self, thresholds: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
        """K15 (on a CPU tensor its plain version) added into ``out``."""
        return kkeys.KERNELS[self.scheme]["key_counts"][0](
            *self.args, thresholds, out=out)

    def counts_plain(self, thresholds: torch.Tensor) -> torch.Tensor:
        return kkeys.KERNELS[self.scheme]["key_counts"][1](*self.args,
                                                           thresholds)

    def extremes(self, out: torch.Tensor) -> torch.Tensor:
        """K16 into rows ``rows`` of ``out`` [n_vectors, 2]."""
        return kkeys.KERNELS[self.scheme]["key_extremes"][0](*self.args,
                                                             out=out)

    def extremes_plain(self) -> torch.Tensor:
        """The plain version's [n, 2] keys of the bucket's vectors."""
        return kkeys.KERNELS[self.scheme]["key_extremes"][1](*self.args)

    def rank_pass(self, thresholds: torch.Tensor, brackets: torch.Tensor,
                  bins: torch.Tensor, mm: torch.Tensor) -> tuple:
        """K17 (on a CPU tensor its plain version): bins added into
        ``bins``, each bracket's least and largest key merged into
        ``mm``."""
        return kkeys.KERNELS[self.scheme]["rank_pass"][0](
            *self.args, thresholds, brackets, bins=bins, mm=mm)

    def rank_pass_plain(self, thresholds: torch.Tensor,
                        brackets: torch.Tensor) -> tuple:
        """The plain version's (bins, [R, 2] keys) of the bucket."""
        return kkeys.KERNELS[self.scheme]["rank_pass"][1](
            *self.args, thresholds, brackets)

    def vector_sums(self, sums: torch.Tensor, keys: torch.Tensor) -> tuple:
        """K18 (on a CPU tensor its plain version) into rows ``rows`` of
        ``sums`` [n_vectors, W + 3] and ``keys`` [n_vectors, 2]."""
        return kgroup.KERNELS[self.scheme]["vector_sum_extremes"][0](
            *self.args, sums, keys)

    def vector_sums_plain(self) -> tuple:
        """The plain version's ([n, W + 3] totals, [n, 2] keys) of the
        bucket's vectors."""
        return kgroup.KERNELS[self.scheme]["vector_sum_extremes"][1](
            *self.args)

    def group_reduce(self, group_keys: torch.Tensor, num_groups: int,
                     out: torch.Tensor, ext: torch.Tensor) -> tuple:
        """K19 (on a CPU tensor its plain version): ``group_keys`` int32
        [n, 1024] aligned with ``rows``; adds into ``out`` [G, W + 4] and
        merges into ``ext`` [G, 2]."""
        return kgroup.KERNELS[self.scheme]["group_reduce"][0](
            *self.args, group_keys, num_groups, out, ext)

    def group_reduce_plain(self, group_keys: torch.Tensor,
                           num_groups: int) -> tuple:
        """The plain version's ([G, W + 4] totals, [G, 2] keys)."""
        return kgroup.KERNELS[self.scheme]["group_reduce"][1](
            *self.args, group_keys, num_groups)


def key_calls(plan, buckets=None) -> list:
    """One :class:`KeyCall` per bucket of a plan (or of ``buckets``): ALP
    buckets with the plan's ALP exception CSR, ALP_RD buckets with its RD
    one."""
    calls = []
    for b in plan.buckets if buckets is None else buckets:
        if b.scheme == C.SCHEME_ALP:
            calls.append(KeyCall("alp", (
                b.args[0], b.bw, *b.args[1:], b.rows, plan.exc_ptr,
                plan.exc_index, plan.exc_bits, plan.n_values), b.rows, b.bw))
        else:
            right, left, dictionary, dict_size = b.args
            calls.append(KeyCall("rd", (
                right, b.bw, left, b.lbw, dictionary, dict_size, b.rows,
                plan.rd_exc_ptr, plan.rd_exc_index, plan.rd_exc_left,
                plan.n_values), b.rows, b.bw))
    return calls


def _key_tensor(plan, keys) -> torch.Tensor:
    """Unsigned keys (numpy) as the signed words the kernels take, on the
    plan's device."""
    kt = _key_type(plan.dtype)
    words = torch.from_numpy(np.ascontiguousarray(keys, kt).view(
        f"i{kt().itemsize}"))
    with tracing.span("alp.fetch.keys.upload"):
        return words.to(plan.device)


def key_count_bins(plan, thresholds: np.ndarray) -> torch.Tensor:
    """The device part of the counting queries: K15 over every bucket into
    one int64 [E + 1] bins tensor on the plan's device, for E ascending
    unsigned keys ``thresholds``; ``#{key <= thresholds[e]}`` is the sum
    of bins 0..e.  No synchronise."""
    thr = _key_tensor(plan, thresholds)
    out = torch.zeros(len(thresholds) + 1, dtype=torch.int64,
                      device=plan.device)
    for call in key_calls(plan):
        call.counts(thr, out)
    return out


def prefix_counts(plan, thresholds) -> np.ndarray:
    """int64 ``#{value key <= t}`` for every unsigned key ``t`` of
    ``thresholds`` (any order, repeats allowed), in one K15 pass a
    bucket."""
    thr = np.asarray(thresholds, dtype=_key_type(plan.dtype))
    if not thr.size:
        return np.zeros(0, np.int64)
    uniq = np.unique(thr)
    bins = key_count_bins(plan, uniq)
    with tracing.span("alp.fetch.prefix_counts"):
        bins = bins.cpu().numpy()
    return np.cumsum(bins)[:-1][np.searchsorted(uniq, thr)]


def vector_extremes(plan) -> torch.Tensor:
    """K16 over every bucket: [n_vectors, 2] (least key, largest key) of
    each vector's values, unsigned keys in the bit patterns' dtype, on the
    plan's device."""
    out = torch.empty((plan.n_vectors, 2), dtype=plan.bits_dtype,
                      device=plan.device)
    for call in key_calls(plan):
        call.extremes(out)
    return out


def _count_keys(plan, klo: int, khi: int) -> int:
    """COUNT of the values whose key lies in [klo, khi]: K15 at the
    thresholds [klo - 1, khi] (only [khi] when klo is 0)."""
    if klo > khi:
        return 0
    if klo == 0:
        return int(prefix_counts(plan, [khi])[0])
    below, upto = prefix_counts(plan, [klo - 1, khi]).tolist()
    return upto - below


@tracing.spanned("alp.engine.query_filter_count")
def query_filter_count(col, lo: float, hi: float, device=None) -> int:
    """SELECT COUNT(*) WHERE lo <= v <= hi (``alp_tpu/engine.py:1336``).
    ``lo``/``hi`` are rounded to the column dtype first, and +-0.0 compare
    equal.  ``device=None`` means ``"cuda"``."""
    dev = resolve_device(device)
    if col.n_values == 0:
        return 0
    return _count_keys(col.plan(dev), _float_key(lo, col.dtype),
                       _float_key(hi, col.dtype))


def key_extent(plan) -> tuple:
    """(least key, largest key) of the column's values as unsigned ints:
    one K16 pass a bucket and one fetch."""
    ext = bias(vector_extremes(plan))
    ends = bias(torch.stack([ext[:, 0].min(), ext[:, 1].max()]))
    mask = (1 << (64 if plan.f64 else 32)) - 1
    with tracing.span("alp.fetch.key_extent"):
        lo, hi = ends.tolist()
    return lo & mask, hi & mask


def _plan_key_extent(plan) -> tuple:
    """``key_extent(plan)``, computed at the plan's first MIN, MAX or
    QUANTILE and kept on it, as the JAX plan keeps its ``_key_extent``."""
    if plan.key_extent is None:
        plan.key_extent = key_extent(plan)
    return plan.key_extent


def _extreme_key(col, device, largest: bool) -> int:
    """The largest (or least) key of the column.  An empty column gives
    the reference's fill key, key 0 for MAX and all ones for MIN
    (``alp_tpu/engine.py:657``, ``:672``): -NaN and +NaN with every
    payload bit set; no plan is built."""
    dev = resolve_device(device)
    if col.n_values == 0:
        return 0 if largest else (1 << (64 if col.dtype == np.float64
                                        else 32)) - 1
    return _plan_key_extent(col.plan(dev))[1 if largest else 0]


@tracing.spanned("alp.engine.query_min")
def query_min(col, device=None) -> float:
    """MIN(column) in the total order (-NaN < -Inf < ... < +Inf < +NaN; an
    all-zero column gives +0.0), from K16's per-vector least keys (the
    plan's kept key extent)."""
    return _key_float(_extreme_key(col, device, False), col.dtype)


@tracing.spanned("alp.engine.query_max")
def query_max(col, device=None) -> float:
    """MAX(column) in the same order, from K16's per-vector largest keys."""
    return _key_float(_extreme_key(col, device, True), col.dtype)


@tracing.spanned("alp.engine.query_topk")
def query_topk(col, k: int, largest: bool = True,
               device=None) -> np.ndarray:
    """TOP-K(column): the k largest (or smallest) values, sorted, in the
    total order with +-0 as +0.0 (``alp_tpu/engine.py:1081``).

    For k <= n_vectors: K16 gives each vector's best key, ``t`` is the
    k-th best of those (``torch.topk``), every value beyond ``t`` lies in
    one of the < k vectors whose best is beyond ``t`` and is decoded
    exactly (``decode_vectors``), and the rest of the answer is ``t``
    repeated; K15 at [t - 1, t] counts the ties, which must suffice.  For
    larger k the full decode and ``torch.topk`` of the keys."""
    if int(k) < 0:
        raise ValueError("k argument to top_k must be nonnegative")
    dev = resolve_device(device)
    k = min(int(k), col.n_values)
    if k == 0:
        return np.empty(0, col.dtype)
    plan = col.plan(dev)
    kt = _key_type(col.dtype)
    width = 64 if col.dtype == np.float64 else 32
    mask = (1 << width) - 1

    def work(biased):           # larger is better, for both orders
        return biased if largest else ~biased

    if k > plan.n_vectors:
        bits = plan.run().view(plan.bits_dtype).reshape(-1)[:col.n_values]
        best = torch.topk(work(biased_keys(bits)), k).values
    else:
        ext = bias(vector_extremes(plan))
        vbest = work(ext[:, 1] if largest else ext[:, 0])
        t = torch.topk(vbest, k).values[-1]
        with tracing.span("alp.fetch.topk.candidates"):
            cands = torch.nonzero(vbest > t).flatten()
        vals = plan.decode_vectors(cands).view(plan.bits_dtype)
        pos = (cands[:, None] * VECTOR_SIZE
               + torch.arange(VECTOR_SIZE, device=dev))
        w = work(biased_keys(vals))
        with tracing.span("alp.fetch.topk.valid"):
            w = w[pos < col.n_values]
        with tracing.span("alp.fetch.topk.above"):
            w = w[w > t]
        above = torch.sort(w, descending=True).values
        n_above = above.shape[0]
        if n_above < k:
            with tracing.span("alp.fetch.topk.threshold"):
                tk = int(bias(work(t))) & mask    # t as an unsigned key
            ties = _count_keys(plan, tk, tk)
            if ties < k - n_above:
                raise RuntimeError(f"TOP-K: {ties} values equal the "
                                   f"threshold, {k - n_above} needed")
        best = torch.cat([above, t.expand(max(k - n_above, 0))])[:k]
    best = bias(work(best))
    with tracing.span("alp.fetch.topk.result"):
        keys = best.cpu().numpy().view(kt)
    return _keys_to_values(keys, col.dtype)


@tracing.spanned("alp.engine.query_histogram")
def query_histogram(col, edges, device=None) -> np.ndarray:
    """GROUP-BY-bin COUNT, ``np.histogram``-compatible: ``len(edges) - 1``
    bins ``[edges[i], edges[i + 1])`` with the last bin closed, bounds
    rounded to the column dtype and +-0 as one (``alp_tpu/engine.py:1156``).
    One K15 pass a bucket at the thresholds ``key(e_i) - 1`` of every edge
    and ``key(e_last)``, for any number of edges."""
    edges = [float(e) for e in edges]
    if len(edges) < 2 or any(a >= b for a, b in zip(edges, edges[1:])):
        raise ValueError("edges must be >= 2 strictly increasing values")
    dev = resolve_device(device)
    E = len(edges)
    if col.n_values == 0:
        return np.zeros(E - 1, np.int64)
    kt = _key_type(col.dtype)
    keys = _float_keys(edges, col.dtype)
    # "< e_i" is "<= key(e_i) - 1"; the last bin closes with "<= key(e_last)"
    khis = np.concatenate([keys - kt(1), keys[-1:]])
    return _histogram_counts(prefix_counts(col.plan(dev), khis), E)


def _histogram_counts(p: np.ndarray, E: int) -> np.ndarray:
    """The E - 1 bin counts from the prefix counts ``p`` at the thresholds
    ``key(e_i) - 1`` of every edge and ``key(e_last)``."""
    out = np.diff(p[:E])
    out[-1] += p[E] - p[E - 1]
    return out


@tracing.spanned("alp.engine.query_filter_sum")
def query_filter_sum(col, lo: float, hi: float, device=None):
    """SELECT SUM(v) WHERE lo <= v <= hi, exact: the correctly rounded sum
    of the selected values (``math.fsum`` of them), as the column dtype's
    scalar (an f32 column rounds the double result once more, as
    ``alp_tpu/engine.py:3941`` does).  An empty selection gives 0.0.  K5-K8
    with the key range [key(lo), key(hi)]."""
    dev = resolve_device(device)
    if col.n_values == 0:
        return 0.0
    klo, khi = _float_key(lo, col.dtype), _float_key(hi, col.dtype)
    if klo > khi:
        return 0.0
    totals = exact_sum_totals(col.plan(dev), key_range=(klo, khi))
    with tracing.span("alp.fetch.filter_sum.totals"):
        rows = totals.tolist()
    with tracing.span("alp.engine.sum.join"):
        return np.dtype(col.dtype).type(
            _finish_sum(*join_totals(rows, col.dtype)))


# ---------------------------------------------------------------------------
# QUANTILE / MEDIAN: exact rank keys by a bisection over K17 passes
# ---------------------------------------------------------------------------

# the K17 passes of the last rank selection (every chunk of its ranks),
# beside ``keys.LAUNCHES["rank_pass"]``: ``LAST_RANK_PASSES`` reads the
# counter ``alp.engine.rank.last_passes``
_RANK = tracing.Counters("alp.engine.rank.", ("last_passes",))


def __getattr__(name):
    if name == "LAST_RANK_PASSES":
        return _RANK["last_passes"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def rank_pass_bins(plan, thresholds: np.ndarray,
                   brackets: np.ndarray) -> tuple:
    """The device part of one bisection pass: K17 over every bucket, for T
    ascending unsigned keys ``thresholds`` and R brackets ``brackets``
    ([R, 2] unsigned keys lo, hi), into (int64 [T + 1] bins as
    ``key_count_bins`` gives them, [R, 2] the least and the largest key of
    the column inside each bracket) on the plan's device.  No
    synchronise."""
    thr = _key_tensor(plan, thresholds)
    br = _key_tensor(plan, np.asarray(brackets, _key_type(plan.dtype))
                     .reshape(-1, 2))
    bins, mm = kkeys.rank_outputs(thr.shape[0], br.shape[0],
                                  plan.bits_dtype, plan.device)
    for call in key_calls(plan):
        call.rank_pass(thr, br, bins, mm)
    return bins, mm


def _probe_budget(n_active: int) -> tuple:
    """(probes a rank, of which uniform in key space) when ``n_active``
    brackets share a pass: 2046 thresholds, two kept for the NaN counts;
    at least half of each rank's are key-space uniform."""
    per = (kkeys.MAX_THRESHOLDS - 2) // n_active
    return per, -(-per // 2)


def rank_pass_bound(width: int, n_ranks: int) -> int:
    """The most passes the bisection of ``n_ranks`` ranks over
    ``width``-bit keys takes.  A rank's ``P_k`` key-space probes cut its
    bracket of width W = hi - lo into pieces of width at most W // P_k
    (``_rank_probes``), so every pass takes at least floor(log2(P_k)) bits
    off (P_k only grows as brackets close); one pass more counts the NaNs
    of a column whose brackets start closed, and one is spare."""
    pk = _probe_budget(n_ranks)[1]
    return -(-width // (pk.bit_length() - 1)) + 2


def _rank_probes(lo: int, hi: int, c_lo: int, c_hi: int, rank: int,
                 j: int, n_active: int, dtype) -> np.ndarray:
    """Probe keys in [lo, hi - 1] for the bracket of ``rank``, the j-th of
    ``n_active`` open brackets (``c_lo``, ``c_hi``: counts known at or
    below lo - 1 and at hi).  Half of them uniform in key space, t_k = lo +
    W * (k * A + j + 1) // (P_k * A + 1) for k < P_k (A = n_active): the
    ranks' grids interleave, so brackets that coincide (as all do at the
    start) share A * P_k distinct probes, and a rank's own grid alone cuts
    its bracket into pieces of width <= W // P_k (``rank_pass_bound``).  A
    quarter uniform in value space (floats are log-spaced in key space),
    interleaved the same way, and a quarter around the value interpolated
    from the counts, when both ends are finite.  Where they go sets only
    the number of passes, never the answer."""
    kt = _key_type(dtype)
    per, pk = _probe_budget(n_active)
    D = pk * n_active + 1
    q, rem = divmod(hi - lo, D)
    m = np.arange(pk, dtype=np.uint64) * np.uint64(n_active) + np.uint64(
        j + 1)
    probes = [kt(lo) + (np.uint64(q) * m
                        + (np.uint64(rem) * m) // np.uint64(D)).astype(kt)]
    vlo, vhi = _key_float(lo, dtype), _key_float(hi, dtype)
    rest = per - pk
    if rest and math.isfinite(vlo) and math.isfinite(vhi):
        pu = rest // 2
        t = (np.arange(pu) * n_active + j + 1) / (pu * n_active + 1)
        frac = min(max((rank - c_lo) / max(c_hi - c_lo, 1), 0.0), 1.0)
        guess = vlo * (1 - frac) + vhi * frac
        step = (vhi - vlo) / (pu + 1)
        values = np.concatenate([vlo * (1 - t) + vhi * t, np.linspace(
            guess - step, guess + step, rest - pu)])
        values = values[np.isfinite(values)]
        keys = _float_keys(values, dtype)
        probes.append(np.clip(keys, kt(lo), kt(hi - 1)).astype(kt))
    return np.concatenate(probes)


def _rank_bisect(plan, ranks: list) -> tuple:
    """The exact total-order keys at 1-based ``ranks`` (at most
    ``MAX_RANKS``) by a bisection over K17 passes: (keys, n_negnan,
    count of keys <= key(+inf), passes).

    For each rank r the bracket [lo, hi] keeps ``#{key <= lo - 1} < r <=
    #{key <= hi}``, from the column's key extent (K16, kept on the plan).
    A pass uploads the probes of every open bracket (deduplicated and
    sorted) and the brackets, runs K17 on every bucket and fetches the
    bins and the bracketed extremes once; every probe narrows every
    rank, then each bracket snaps to the least and largest key inside it.
    The first pass also counts at key(-inf) - 1 and key(+inf), which give
    the NaNs of both signs, and runs even when every bracket starts
    closed.  Past ``rank_pass_bound`` passes it raises."""
    kt = _key_type(plan.dtype)
    R = len(ranks)
    least, largest = _plan_key_extent(plan)
    lo, hi = [least] * R, [largest] * R
    c_lo, c_hi = [0] * R, [plan.n_values] * R
    specials = [_float_key(-math.inf, plan.dtype) - 1,
                _float_key(math.inf, plan.dtype)]
    limit = rank_pass_bound(8 * kt().itemsize, R)
    passes, negnan, le_pinf = 0, 0, 0
    while passes == 0 or any(a < b for a, b in zip(lo, hi)):
        if passes >= limit:
            raise RuntimeError(f"QUANTILE: {R} rank brackets still open "
                               f"after {limit} passes")
        with tracing.span("alp.engine.rank.pass"):
            with tracing.span("alp.engine.rank.probes"):
                active = ([r for r in range(R) if lo[r] < hi[r]]
                          or list(range(R)))
                probes = [_rank_probes(lo[r], hi[r], c_lo[r], c_hi[r],
                                       ranks[r], j, len(active), plan.dtype)
                          for j, r in enumerate(active) if lo[r] < hi[r]]
                if passes == 0:
                    probes.append(np.array(specials, kt))
                thr = np.unique(np.concatenate(probes))
            bins, mm = rank_pass_bins(plan, thr, [(lo[r], hi[r])
                                                  for r in active])
            fetched = torch.cat([bins, mm.reshape(-1).to(torch.int64)])
            with tracing.span("alp.fetch.rank.bins"):
                fetched = fetched.cpu().numpy()
            with tracing.span("alp.engine.rank.narrow"):
                counts = np.cumsum(fetched[:thr.shape[0]])
                mm = fetched[thr.shape[0] + 1:].astype(kt).reshape(-1, 2)
                for r in range(R):
                    e = int(np.searchsorted(counts, ranks[r], "left"))
                    if e < thr.shape[0]:       # the first count >= rank
                        hi[r] = min(hi[r], int(thr[e]))
                        c_hi[r] = min(c_hi[r], int(counts[e]))
                    if e > 0:
                        lo[r] = max(lo[r], int(thr[e - 1]) + 1)
                        c_lo[r] = max(c_lo[r], int(counts[e - 1]))
                for r, (least, largest) in zip(active, mm.tolist()):
                    if least > largest:
                        raise RuntimeError(f"QUANTILE: rank {ranks[r]}'s "
                                           f"bracket holds no value")
                    lo[r], hi[r] = max(lo[r], least), min(hi[r], largest)
                if passes == 0:
                    at = np.searchsorted(thr, np.array(specials, kt))
                    negnan = int(counts[at[0]])
                    le_pinf = int(counts[at[1]])
        passes += 1
    return lo, negnan, le_pinf, passes


def _select_rank_keys(col, plan, ranks) -> tuple:
    """The exact keys at the ascending 1-based ``ranks``, chunked by
    ``MAX_RANKS``: ({rank: key}, n_negnan, n_posnan).  Sets
    ``LAST_RANK_PASSES``."""
    keys, passes = {}, 0
    negnan = le_pinf = 0
    for s in range(0, len(ranks), kkeys.MAX_RANKS):
        chunk = list(ranks[s:s + kkeys.MAX_RANKS])
        got, negnan, le_pinf, p = _rank_bisect(plan, chunk)
        keys.update(zip(chunk, got))
        passes += p
    _RANK["last_passes"] = passes
    return keys, negnan, col.n_values - le_pinf


@tracing.spanned("alp.engine.query_quantile")
def query_quantile(col, q, interpolation: str = "linear", device=None):
    """QUANTILE(column, q), numpy-compatible (``alp_tpu/engine.py:3710``):
    ``q`` a scalar or sequence in [0, 1], the methods ``linear``,
    ``lower``, ``higher``, ``midpoint`` and ``nearest``; a scalar ``q``
    gives the column dtype's scalar, a sequence an array.  Any NaN in the
    column gives NaN; an empty column NaN.  The neighbouring values at the
    straddling ranks are exact (``_select_rank_keys``); only the final
    interpolation is floating-point, numpy's ``_lerp`` operation for
    operation in the column dtype.  ``device=None`` means ``"cuda"``."""
    qs = np.atleast_1d(np.asarray(q, np.float64))
    if qs.size and (np.isnan(qs).any() or qs.min() < 0 or qs.max() > 1):
        raise ValueError("quantiles must be in [0, 1]")
    dev = resolve_device(device)
    n = col.n_values
    scalar = np.isscalar(q) or getattr(q, "ndim", 1) == 0
    if n == 0:
        out = np.full(qs.shape, np.nan, col.dtype)
        return col.dtype.type(out[0]) if scalar else out
    plan = col.plan(dev)
    hs = qs * (n - 1)
    ranks = set()
    for h in hs:
        i = int(np.floor(h))
        ranks.add(i + 1)
        # the upper neighbor is the CEIL-rank value: at integer h it is
        # the same element (numpy semantics), so only straddling
        # positions need a second rank
        if h != i and interpolation in (
                "linear", "higher", "midpoint", "nearest") and i + 1 < n:
            ranks.add(i + 2)
    keys, n_negnan, n_posnan = _select_rank_keys(col, plan, sorted(ranks))
    if n_negnan or n_posnan:
        out = np.full(qs.shape, np.nan, col.dtype)
        return col.dtype.type(out[0]) if scalar else out
    vals = {r: _key_float(k, col.dtype) for r, k in keys.items()}
    dt = col.dtype.type
    out = np.empty(qs.shape, col.dtype)
    for ix, h in np.ndenumerate(hs):
        i = int(np.floor(h))
        t = h - i
        a = vals[i + 1]
        b = vals[i + 2] if (t > 0 and (i + 2) in vals) else a
        if interpolation == "lower":
            r = a
        elif interpolation == "higher":
            r = b if t > 0 else a
        elif interpolation == "midpoint":
            r = (dt(a) + dt(b)) / dt(2) if t > 0 else dt(a)
        elif interpolation == "nearest":
            # numpy: round half toward the EVEN-index neighbor
            if t < 0.5 or (t == 0.5 and i % 2 == 0):
                r = a
            else:
                r = b
        elif interpolation == "linear":
            if t == 0:
                r = a          # exact rank hit: no arithmetic (a == b)
            else:
                # numpy's _lerp, reproduced operation-for-operation
                diff = dt(b) - dt(a)
                r = dt(a) + diff * dt(t)
                if t >= 0.5:
                    r = dt(b) - diff * dt(1 - t)
        else:
            raise ValueError(f"unknown interpolation {interpolation!r}")
        out[ix] = r
    return dt(out[0]) if scalar else out


@tracing.spanned("alp.engine.query_median")
def query_median(col, device=None):
    """MEDIAN(column): ``query_quantile(col, 0.5)``, ``np.median``'s
    answer."""
    return query_quantile(col, 0.5, device=device)


# ---------------------------------------------------------------------------
# GROUP-BY, windows, DISTINCT: K18 per-vector totals, K19 per-group totals
# ---------------------------------------------------------------------------

def group_calls(plan, vectors=None) -> list:
    """The K18/K19 calls of a plan: ``key_calls(plan)``, or with
    ``vectors`` (int64 vector ids on the plan's device) the same calls cut
    to those vectors, each bucket's per-row arguments sliced."""
    if vectors is None:
        return key_calls(plan)
    mark = torch.zeros(plan.n_vectors, dtype=torch.bool, device=plan.device)
    with tracing.span("alp.fetch.groups.mark"):   # True goes up as a tensor
        mark[vectors] = True
    parts = []
    for b in plan.buckets:
        with tracing.span("alp.fetch.groups.select"):
            sel = torch.nonzero(mark[b.rows]).flatten()
        if sel.numel():
            parts.append(dataclasses.replace(
                b, rows=b.rows[sel], args=tuple(a[sel] for a in b.args)))
    return key_calls(plan, parts)


def vector_sums(plan) -> tuple:
    """K18 over every bucket: (int64 [n_vectors, W + 3] exact-SUM totals
    of each vector, [n_vectors, 2] its least and largest key, unsigned in
    the bit patterns' dtype) on the plan's device.  No synchronise."""
    sums = torch.empty((plan.n_vectors, kes.WINDOWS[plan.bits_dtype] + 3),
                       dtype=torch.int64, device=plan.device)
    keys = torch.empty((plan.n_vectors, 2), dtype=plan.bits_dtype,
                       device=plan.device)
    for call in key_calls(plan):
        call.vector_sums(sums, keys)
    return sums, keys


def _plan_vector_sums(plan) -> tuple:
    """``vector_sums(plan)``, computed at the plan's first ordered GROUP-BY
    or window query and kept on it (18 MB for a 256 MiB f64 column)."""
    if plan.vector_sums is None:
        plan.vector_sums = vector_sums(plan)
    return plan.vector_sums


def group_reduce(plan, keys: torch.Tensor, num_groups: int, rows=None,
                 run_values: int = kes.MAX_VALUES) -> tuple:
    """K19 over every bucket (``keys`` int32 [n_vectors, 1024], the group
    id of every value in column order) or over the vectors ``rows`` (int64
    [m]; ``keys`` [m, 1024] aligned with them): ([int64 [G, W + 4] totals
    and counts, one for each run of fewer than ``run_values`` values],
    [G, 2] least and largest keys) on the plan's device.  The runs' totals
    add up as integers.  No synchronise beyond the cut of the buckets to
    ``rows``."""
    dev = plan.device
    if rows is None:
        rows = torch.arange(plan.n_vectors, device=dev)
    slot = torch.full((plan.n_vectors,), -1, dtype=torch.int64, device=dev)
    slot[rows] = torch.arange(rows.shape[0], device=dev)
    max_rows = max(1, (run_values - 1) // VECTOR_SIZE)
    outs = []
    out, ext = kgroup.group_outputs(num_groups, plan.bits_dtype, dev)
    for lo in range(0, rows.shape[0], max_rows):
        part = rows[lo:lo + max_rows]
        if outs:
            out = torch.zeros_like(out)
        calls = (key_calls(plan) if part.shape[0] == plan.n_vectors
                 else group_calls(plan, part))
        for call in calls:
            call.group_reduce(keys[slot[call.rows]], num_groups, out, ext)
        outs.append(out)
    return outs, ext


@dataclasses.dataclass
class Groups:
    """Host totals of G groups (or window cells): ``limbs`` int64 [G, L],
    each group's exact sum times 2^B as carried base-2^32 limbs (limb j
    weighs 2^(32 (base + j)); every limb but the last in [0, 2^32), the
    last signed); ``sp`` int64 [G, 3] NaN, +Inf and -Inf counts; ``ct``
    int64 [G] row counts; ``kmn`` / ``kmx`` [G] least and largest unsigned
    keys (all ones and 0 for an empty group).  ``totals`` gives the same
    sums as Python ints, {g: sum} for the nonzero ones."""
    limbs: np.ndarray
    base: int
    sp: np.ndarray
    ct: np.ndarray
    kmn: np.ndarray
    kmx: np.ndarray

    @functools.cached_property
    def totals(self) -> dict:
        rows = np.flatnonzero(self.limbs.any(1))
        shifts = [32 * (self.base + j) for j in range(self.limbs.shape[1])]
        return {g: sum(v << k for v, k in zip(row, shifts) if v)
                for g, row in zip(rows.tolist(), self.limbs[rows].tolist())}

    def grand_total(self) -> int:
        """The sum of every group's total (times 2^B), a Python int."""
        return sum(int(v) << (32 * (self.base + j))
                   for j, v in enumerate(self.limbs.sum(0).tolist()))


def _carry(limbs: np.ndarray) -> np.ndarray:
    """Carry int64 limbs [G, L] in place (every limb but the last into
    [0, 2^32), the last signed), their values unchanged; each limb must
    stay within 2^62."""
    for j in range(limbs.shape[1] - 1):
        limbs[:, j + 1] += limbs[:, j] >> 32
        limbs[:, j] &= 0xFFFFFFFF
    return limbs


def _join_limbs(parts: list, at: list, W: int, G: int) -> tuple:
    """(limbs, base) of :class:`Groups`: the sum over the parts of
    part[i, w] << 32 w, part i being group ``at[i]`` (``at`` None: group
    i, else distinct groups), over the windows any part uses.  Each window
    total splits into its low and high 32 bits, added into two limbs."""
    used = np.zeros(W, bool)
    for part in parts:
        used |= np.bitwise_or.reduce(part[:, :W], axis=0) != 0
    if not used.any():
        return np.zeros((G, 1), np.int64), 0
    lo, hi = np.flatnonzero(used)[[0, -1]].tolist()
    k = hi - lo + 1
    limbs = np.zeros((G, k + 3), np.int64)  # room for the carries
    for part, where in zip(parts, at):
        t = part[:, lo:hi + 1]
        rows = slice(None) if where is None else where
        limbs[rows, :k] += t & 0xFFFFFFFF
        limbs[rows, 1:k + 1] += t >> 32
    return _carry(limbs), lo


def _round_window(top, mid, low, sticky, h, scale: int) -> tuple:
    """Round nonnegative integers over 2^scale to doubles, once, to
    nearest even: each is ``top`` 2^(32 h) + ``mid`` 2^(32 (h - 1)) +
    ``low`` 2^(32 (h - 2)) plus a part below, nonzero where ``sticky``
    (uint64 limbs below 2^32, ``top`` nonzero).  (the doubles, the mask of
    those that are normal: the others, subnormal or past the largest
    double, read 0.0)."""
    one = np.uint64(1)
    bl = np.frexp(top.astype(np.float64))[1].astype(np.uint64)  # 1 .. 32
    lead = (top << (np.uint64(64) - bl)) | (mid << (np.uint64(32) - bl)) \
        | (low >> bl)
    sticky = sticky | ((low & ((one << bl) - one)) != 0) \
        | ((lead & np.uint64(0x3FF)) != 0)
    mant = lead >> np.uint64(11)
    guard = ((lead >> np.uint64(10)) & one) == one
    mant += (guard & (sticky | ((mant & one) == one))).astype(np.uint64)
    e = 32 * (h - 2) + bl.astype(np.int64) + 11 - scale
    ok = (e >= -1074) & (e <= 970)
    return np.ldexp(mant.astype(np.float64),
                    np.where(ok, e, 0).astype(np.int32)) * ok, ok


def _rounded(gr: Groups, scale: int, rows: np.ndarray, aggs) -> dict:
    """{"sum", "mean"} (those in ``aggs``) -> float64 [G]: the exact total
    of each group in ``rows`` (a bool mask) over 2^scale, or over its count
    times 2^scale, rounded once to nearest even, as ``int / int`` rounds
    it; 0.0 for a zero total and outside ``rows``.  Vectorised over the
    groups' limbs; a result outside the normal range goes through Python's
    ``int / int`` (which raises ``OverflowError`` past DBL_MAX), as does a
    mean over 2^32 rows or more."""
    G = gr.ct.shape[0]
    out = {a: np.zeros(G, np.float64) for a in ("sum", "mean") if a in aggs}
    limbs = gr.limbs
    idx = np.flatnonzero(rows & limbs.any(1))
    if not idx.size or not out:
        return out
    m = limbs[idx]
    neg = m[:, -1] < 0
    m[neg] = _carry(-m[neg])
    R, L = m.shape
    nz = m != 0
    h = L - 1 - np.argmax(nz[:, ::-1], axis=1)       # the top limb
    least = np.argmax(nz, axis=1)                    # the lowest nonzero
    # every limb now in [0, 2^32); three zero limbs below limb 0
    m = np.concatenate([np.zeros((R, 3), np.int64), m], axis=1).view(
        np.uint64).ravel()
    at = np.arange(R) * (L + 3) + 3

    def limb(j):
        return m[at + j]

    for a, res in out.items():
        slow = np.zeros(R, bool)
        if a == "sum":
            val, ok = _round_window(limb(h), limb(h - 1), limb(h - 2),
                                    least < h - 2, gr.base + h, scale)
        else:
            ct = gr.ct[idx].astype(np.uint64)
            slow |= ct >= np.uint64(1 << 32)
            d = np.maximum(ct, np.uint64(1))
            rem = np.zeros(R, np.uint64)
            q = []
            for j in range(4):       # the four limbs from the top, by d
                cur = (rem << np.uint64(32)) | limb(h - j)
                q.append(cur // d)
                rem = cur % d
            lead = q[0] != 0
            val, ok = _round_window(
                np.where(lead, q[0], q[1]), np.where(lead, q[1], q[2]),
                np.where(lead, q[2], q[3]),
                (rem != 0) | (least < h - 3) | (lead & (q[3] != 0)),
                gr.base + np.where(lead, h, h - 1), scale)
        res[idx] = np.where(neg, -val, val)
        for i in np.flatnonzero(slow | ~ok).tolist():
            g = int(idx[i])
            t = sum(int(v) << (32 * (gr.base + j))
                    for j, v in enumerate(limbs[g].tolist()))
            res[g] = t / ((int(gr.ct[g]) if a == "mean" else 1) << scale)
    return out


def _unordered_keys(plan, keys: np.ndarray) -> torch.Tensor:
    """int32 [n_vectors, 1024] group ids in column order on the plan's
    device, -1 in the pad."""
    kv = np.full(plan.n_vectors * VECTOR_SIZE, -1, np.int32)
    kv[:plan.n_values] = keys
    with tracing.span("alp.fetch.groups.keys_upload"):
        return torch.from_numpy(kv.reshape(-1, VECTOR_SIZE)).to(plan.device)


def _unordered_host(dtype, outs: list, ext: torch.Tensor) -> Groups:
    """The host join of K19's runs over the whole column (of value
    ``dtype``): int64 [G, W + 4] runs ``outs``, [G, 2] keys ``ext``."""
    W = outs[0].shape[1] - 4
    with tracing.span("alp.fetch.groups.unordered"):
        parts = [o.cpu().numpy() for o in outs]
        ext = ext.cpu().numpy().view(_key_type(dtype))
    return Groups(*_join_limbs(parts, [None] * len(parts), W,
                               parts[0].shape[0]),
                  sum(p[:, W:W + 3] for p in parts),
                  sum(p[:, W + 3] for p in parts), ext[:, 0].copy(),
                  ext[:, 1].copy())


def _unordered_groups(plan, keys: np.ndarray, num_groups: int) -> Groups:
    """K19 over the whole column with the keys in column order."""
    return _unordered_host(plan.dtype, *group_reduce(
        plan, _unordered_keys(plan, keys), num_groups))


@dataclasses.dataclass
class _OrderedLayout:
    """What the ordered route of a set of contiguous groups needs on the
    device, made once on the host (``_ordered_layout``)."""
    bounds: np.ndarray             # int64 [G + 1] row bounds of the groups
    lo_v: torch.Tensor             # [G] first whole vector of each group
    hi_v: torch.Tensor             # [G] one past its last whole vector
    owner: torch.Tensor            # [n_vectors] group of a whole vector, G
    cross: torch.Tensor            # [m] vectors a group boundary crosses
    cross_keys: torch.Tensor       # int32 [m, 1024] their local group ids
    touched: np.ndarray            # [T] the groups those ids stand for


def _ordered_layout(plan, bounds: np.ndarray, cross_keys) -> _OrderedLayout:
    """The whole vectors of each group and the crossed vectors with their
    keys, relabelled to the groups they touch: ``cross_keys(vector ids)``
    gives (the groups, int32 [m, 1024] each row's index among them, -1 past
    the last row), as :func:`_keys_of` and :func:`_cells_of` make them."""
    n, nv, dev = plan.n_values, plan.n_vectors, plan.device
    G = len(bounds) - 1
    V = VECTOR_SIZE
    lo_v = -(-bounds[:-1] // V)
    hi_v = np.maximum(np.where(bounds[1:] >= n, nv, bounds[1:] // V), lo_v)
    inner = bounds[1:-1]
    cross = np.unique(inner[(inner % V != 0) & (inner < n)] // V)
    whole = np.ones(nv, bool)
    whole[cross] = False
    lens = hi_v - lo_v
    if int(lens.sum()) != int(whole.sum()):
        raise RuntimeError("GROUP-BY: whole vectors and group ranges "
                           "disagree")
    owner = np.full(nv, G, np.int64)
    owner[whole] = np.repeat(np.arange(G), lens)
    touched = np.zeros(0, np.int64)
    lk = np.zeros((0, V), np.int32)
    if cross.size:
        touched, lk = cross_keys(cross)
    up = functools.partial(torch.as_tensor, device=dev)
    with tracing.span("alp.fetch.groups.layout_upload"):
        return _OrderedLayout(bounds, up(lo_v), up(hi_v), up(owner),
                              up(cross.astype(np.int64)), up(lk), touched)


def _ordered_device(plan, lay: _OrderedLayout, vs: torch.Tensor,
                    vk: torch.Tensor) -> tuple:
    """The device part of the ordered route, from K18's per-vector totals
    ``vs`` and keys ``vk``: ([int64 totals a run of the whole vectors'
    prefix sums, then K19's runs over the crossed vectors], [None for each
    whole-vector run, ``touched`` for each K19 run], [G, 2] least and
    largest keys)."""
    nv, dev = plan.n_vectors, plan.device
    G = len(lay.bounds) - 1
    run = max(1, (kes.MAX_VALUES - 1) // VECTOR_SIZE)
    parts = []
    for r0 in range(0, nv, run):
        r1 = min(nv, r0 + run)
        cs = torch.cat([vs.new_zeros((1, vs.shape[1])), vs[r0:r1].cumsum(0)])
        parts.append(cs[lay.hi_v.clamp(r0, r1) - r0]
                     - cs[lay.lo_v.clamp(r0, r1) - r0])
    bk = bias(vk)
    info = torch.iinfo(bk.dtype)
    kmn = torch.full((G + 1,), info.max, dtype=bk.dtype, device=dev)
    kmx = torch.full((G + 1,), info.min, dtype=bk.dtype, device=dev)
    kmn.scatter_reduce_(0, lay.owner, bk[:, 0], "amin")
    kmx.scatter_reduce_(0, lay.owner, bk[:, 1], "amax")
    ext = bias(torch.stack([kmn[:G], kmx[:G]], dim=1))
    at = [None] * len(parts)
    if lay.touched.size:
        outs, cext = group_reduce(plan, lay.cross_keys, len(lay.touched),
                                  lay.cross)
        parts += outs
        at += [lay.touched] * len(outs)
        with tracing.span("alp.fetch.groups.touched_upload"):
            t_at = torch.from_numpy(lay.touched).to(dev)
        merged = bias(ext[t_at])
        cext = bias(cext)
        ext[t_at] = bias(torch.stack([torch.minimum(merged[:, 0], cext[:, 0]),
                                      torch.maximum(merged[:, 1], cext[:, 1])],
                                     dim=1))
    return parts, at, ext


def _ordered_host(plan, lay: _OrderedLayout, parts: list, at: list,
                  ext: torch.Tensor) -> Groups:
    """The host join of the ordered route's device part."""
    G = len(lay.bounds) - 1
    W = kes.WINDOWS[plan.bits_dtype]
    with tracing.span("alp.fetch.groups.ordered"):
        parts = [p.cpu().numpy() for p in parts]
        ext = ext.cpu().numpy().view(_key_type(plan.dtype))
    sp = np.zeros((G, 3), np.int64)
    for p, where in zip(parts, at):
        if where is None:
            sp += p[:, W:W + 3]
        else:
            sp[where] += p[:, W:W + 3]
    return Groups(*_join_limbs(parts, at, W, G), sp, np.diff(lay.bounds),
                  ext[:, 0].copy(), ext[:, 1].copy())


def _ordered_groups(plan, bounds: np.ndarray, cross_keys) -> Groups:
    """Contiguous groups, group g the rows bounds[g] .. bounds[g + 1] - 1.
    The vectors that lie whole in a group add their K18 totals (kept on
    the plan) through an int64 prefix sum over the vectors and two gathers
    a group, in runs of fewer than 2^31 values, and their keys through a
    segmented least and largest; the vectors that a group boundary crosses
    go through K19 with their keys ``cross_keys(vector ids)``, relabelled
    to the groups they touch (:func:`_ordered_layout`).  K18 skips the pad,
    so a partial last vector needs nothing of its own."""
    lay = _ordered_layout(plan, bounds, cross_keys)
    return _ordered_host(plan, lay, *_ordered_device(
        plan, lay, *_plan_vector_sums(plan)))


@tracing.spanned("alp.engine.groups.finish")
def _finish_groups(gr: Groups, aggs, dtype) -> dict:
    """The aggregates ``aggs`` of every group as the JAX package gives them
    (``alp_tpu/engine.py:2814-2864``): counts int64; SUM the exact sum
    rounded once, an f32 column's to a double and then to float32; MEAN the
    exact rational mean, rounded the same way, NaN for an empty group; NaN,
    or +Inf with -Inf, gives NaN and an infinity wins otherwise
    (``_finish_sum``); MIN / MAX the values of the least and largest keys
    (+0.0 for a group of zeros), NaN for an empty group.  The roundings
    are those of ``float(Fraction(...))``, vectorised over the groups
    (``_rounded``).  A group with a NaN or an infinity is decided by those
    alone, before any division: its finite part may pass DBL_MAX, where
    the division would raise ``OverflowError`` (as a finite group past
    DBL_MAX does, in both packages)."""
    dtype = np.dtype(dtype)
    scale = _SCALE[dtype]
    special = gr.sp.any(1)
    decided = [(g, _finish_sum(0, *sp, scale)) for g, sp in zip(
        np.flatnonzero(special).tolist(), gr.sp[special].tolist())]
    res = {"count": gr.ct.astype(np.int64)}
    for a, vals in _rounded(gr, scale, ~special, aggs).items():
        for g, v in decided:
            vals[g] = v
        if a == "mean":
            vals[gr.ct == 0] = np.nan
        res[a] = vals.astype(dtype)
    nan = np.array(np.nan, dtype)
    with np.errstate(invalid="ignore"):     # an f32 NaN through a double
        for a, k in (("max", gr.kmx), ("min", gr.kmn)):
            if a in aggs:
                res[a] = np.where(gr.ct > 0, _keys_to_values(k, dtype), nan)
    return {a: res[a] for a in aggs if a in res}


def _empty_groups(num_groups: int, aggs, dtype) -> dict:
    """The answer over an empty column (``alp_tpu/engine.py:2797-2805``)."""
    out = {}
    for a in aggs:
        if a == "count":
            out[a] = np.zeros(num_groups, np.int64)
        elif a == "sum":
            out[a] = np.zeros(num_groups, dtype)
        else:
            out[a] = np.full(num_groups, np.nan, dtype)
    return out


def _check_num_groups(num_groups: int) -> None:
    if num_groups <= 0 or num_groups > kgroup.MAX_GROUPS:
        raise ValueError("num_groups must be in [1, 2^24]")


def group_totals(col, keys, num_groups: int, device=None):
    """The exact per-group totals of :func:`query_groupby` before the
    host's rounding (a :class:`Groups`; None for an empty column), with its
    argument checks.  Keys in non-decreasing order make every group a
    range of rows: the vectors inside a group add their K18 totals, kept on
    the plan, and only the vectors that a boundary crosses go through K19.
    Any other keys go through K19 over the whole column, in one pass."""
    keys = _checked_keys(col, keys, num_groups)
    dev = resolve_device(device)
    if col.n_values == 0:
        return None
    plan = col.plan(dev)
    bounds = _key_bounds(keys, num_groups)
    if bounds is not None:
        return _ordered_groups(plan, bounds, _keys_of(keys, col.n_values))
    return _unordered_groups(plan, keys, num_groups)


def _checked_keys(col, keys, num_groups: int) -> np.ndarray:
    """The reference's checks of GROUP-BY keys; the keys as int64."""
    keys = np.ascontiguousarray(np.asarray(keys, np.int64))
    if keys.shape != (col.n_values,):
        raise ValueError(f"keys must have shape ({col.n_values},)")
    _check_num_groups(num_groups)
    if keys.size and (keys.min() < 0 or keys.max() >= num_groups):
        raise ValueError("keys out of range [0, num_groups)")
    return keys


def _key_bounds(keys: np.ndarray, num_groups: int):
    """The row bounds of every group when the keys are in non-decreasing
    order (the ordered route), else None."""
    if keys.size < 2 or bool(np.all(keys[1:] >= keys[:-1])):
        return np.searchsorted(keys, np.arange(num_groups + 1))
    return None


def _keys_of(keys: np.ndarray, n: int):
    """The ``cross_keys`` of :func:`_ordered_layout` from the int64 key of
    every row: vector ids -> (the groups their rows hold, int32 [m, 1024]
    each row's index among them, -1 in a partial last vector's pad)."""
    def cross_keys(vecs):
        rows = vecs[:, None] * VECTOR_SIZE + np.arange(VECTOR_SIZE)
        valid = rows < n
        touched, local = np.unique(keys[rows[valid]], return_inverse=True)
        lk = np.full(rows.shape, -1, np.int32)
        lk[valid] = local
        return touched, lk
    return cross_keys


# crossed vectors whose cell ids a step of _cells_of makes (int64 on the
# device: 512 MiB)
_CELL_CHUNK = 1 << 16


def _cells_of(n: int, hop: int, dev):
    """The ``cross_keys`` of :func:`_ordered_layout` for cells of ``hop``
    rows over n rows, made on ``dev`` (no [m, 1024] array on the host): the
    cells of vector v are a range from (1024 v) // hop, and row j of it
    lies ((1024 v) % hop + j) // hop cells after the first."""
    def cross_keys(vecs):
        V = VECTOR_SIZE
        first = vecs * V // hop
        span = (np.minimum(vecs * V + V, n) - 1) // hop - first + 1
        cells = np.repeat(first - np.cumsum(span) + span, span) \
            + np.arange(int(span.sum()))
        keep = np.ones(cells.size, bool)      # ascending: drop repeats
        keep[1:] = cells[1:] != cells[:-1]
        touched = cells[keep]
        with tracing.span("alp.fetch.groups.cells_upload"):
            at = torch.as_tensor(np.searchsorted(touched, first), device=dev)
            off = torch.as_tensor(vecs * V % hop, device=dev)
        row = torch.arange(V, device=dev)
        lk = torch.empty((len(vecs), V), dtype=torch.int32, device=dev)
        for c in range(0, len(vecs), _CELL_CHUNK):
            s = slice(c, c + _CELL_CHUNK)
            lk[s] = at[s, None] + (off[s, None] + row) // hop
        tail = n - int(vecs[-1]) * V
        if tail < V:
            lk[-1, tail:] = -1
        return touched, lk
    return cross_keys


@tracing.spanned("alp.engine.query_groupby")
def query_groupby(col, keys, num_groups: int,
                  aggs=("sum", "count", "min", "max", "mean"),
                  device=None) -> dict:
    """GROUP-BY aggregate, ``SELECT key, AGG(v) ... GROUP BY key``
    (``alp_tpu/engine.py:2750``): ``keys`` an int array of length
    ``col.n_values`` with values in [0, num_groups); a dict of
    [num_groups] numpy arrays for the requested aggregates.  SUM and MEAN
    exact (each group's ``math.fsum`` and exact mean, rounded once; NaN, or
    +Inf with -Inf, gives NaN; empty groups sum 0.0, mean NaN), COUNT the
    rows, MIN / MAX in the total order (NaN above +Inf; empty groups NaN).
    The device part is :func:`group_totals`.  ``device=None`` means
    ``"cuda"``."""
    gr = group_totals(col, keys, num_groups, device)
    if gr is None:
        return _empty_groups(num_groups, aggs, col.dtype)
    return _finish_groups(gr, aggs, col.dtype)


def window_totals(col, window: int, hop: int | None = None, device=None):
    """The exact per-window totals of :func:`query_window` before the
    host's rounding (a :class:`Groups`; None for an empty column), with its
    argument checks.  Cells of ``hop`` rows are contiguous, so they take
    the ordered route of :func:`group_totals`, the cell ids of the vectors
    a cell boundary crosses made on the device (:func:`_cells_of`); a sliding
    window adds its cells' integer totals, counts and special counts and
    takes the least and largest of their keys, on the host."""
    if window <= 0:
        raise ValueError("window must be positive")
    n = col.n_values
    if hop is None:
        hop = window
    if hop <= 0 or window % hop:
        raise ValueError("hop must be positive and divide window")
    ncells = max(-(-n // hop), 1)
    if hop == window:
        _check_num_groups(ncells)
    dev = resolve_device(device)
    if n == 0:
        return None
    bounds = np.minimum(np.arange(ncells + 1, dtype=np.int64) * hop, n)
    cells = _ordered_groups(col.plan(dev), bounds, _cells_of(n, hop, dev))
    if hop == window:
        return cells
    k = window // hop
    nw = max(-(-max(n - window, 0) // hop) + 1, 1)
    end = np.minimum(np.arange(nw) + k, ncells)

    def windowed(a):             # sums of cells i .. i + k - 1, clipped
        c = np.concatenate([np.zeros((1,) + a.shape[1:], a.dtype),
                            np.cumsum(a, axis=0)])  # may wrap: the
        return c[end] - c[:nw]                      # differences do not

    kmn = np.full(nw, ~_key_type(col.dtype)(0))
    kmx = np.zeros(nw, _key_type(col.dtype))
    for j in range(k):
        at = np.minimum(np.arange(nw) + j, ncells - 1)
        kmn = np.minimum(kmn, cells.kmn[at])
        kmx = np.maximum(kmx, cells.kmx[at])
    # a window's limb adds at most k carried limbs, each below 2^32
    return Groups(_carry(windowed(cells.limbs)), cells.base,
                  windowed(cells.sp), windowed(cells.ct), kmn, kmx)


@tracing.spanned("alp.engine.query_window")
def query_window(col, window: int,
                 aggs=("sum", "count", "min", "max", "mean"),
                 hop: int | None = None, device=None) -> dict:
    """Windowed aggregates over row order, exact as :func:`query_groupby`
    (``alp_tpu/engine.py:2867``).  Tumbling (``hop`` None or ``window``):
    window w covers rows [w * window, (w + 1) * window), ceil(n / window)
    of them.  Sliding (``hop`` < ``window`` and dividing it): window i
    covers [i * hop, i * hop + window); one pass computes hop-sized cells
    and each window adds its cells' integer totals, then rounds once.  The
    device part is :func:`window_totals`."""
    gr = window_totals(col, window, hop, device)
    if gr is None:
        return _empty_groups(1, aggs, col.dtype)
    return _finish_groups(gr, aggs, col.dtype)


# values sorted at once by DISTINCT: ``torch.sort`` refuses more than
# INT_MAX elements, and a chunk's sort holds its keys twice and int64
# indices beside them (16 GiB at 2^29 f64 values)
DISTINCT_CHUNK = 1 << 29


@tracing.spanned("alp.engine.query_distinct")
def query_distinct(col, device=None) -> int:
    """COUNT(DISTINCT v) (``alp_tpu/engine.py:2217``): -0.0 equals 0.0 and
    every NaN counts as one value.  The plan's decode (K1-K4, the
    exceptions written in), then, a chunk of DISTINCT_CHUNK values at a
    time, the total-order keys with every NaN folded onto one,
    ``torch.sort`` and the distinct keys (adjacent unequal ones); a chunk
    counts those that no earlier chunk holds (``torch.searchsorted`` in
    each earlier chunk's distinct keys), on the device.  The JAX package
    sorts the whole column in XLA, outside any kernel."""
    dev = resolve_device(device)
    if col.n_values == 0:
        return 0
    plan = col.plan(dev)
    bits = plan.run().view(plan.bits_dtype).reshape(-1)[:col.n_values]
    it = np.dtype(f"i{np.dtype(col.dtype).itemsize}")
    pinf, ninf = np.array([math.inf, -math.inf], col.dtype).view(it).tolist()
    ninf ^= int(np.iinfo(it).max)        # biased_keys of +Inf and -Inf
    n, seen, count = col.n_values, [], 0
    for lo in range(0, n, DISTINCT_CHUNK):
        last = lo + DISTINCT_CHUNK >= n
        keys = biased_keys(bits[lo:lo + DISTINCT_CHUNK])
        if last:
            del bits             # the decode, once the last keys are made
        keys = torch.where((keys > pinf) | (keys < ninf), pinf + 1, keys)
        keys = torch.sort(keys).values
        if not seen and last:    # one chunk: nothing to search
            steps = (keys[1:] != keys[:-1]).sum()
            with tracing.span("alp.fetch.distinct.count"):
                return int(steps) + 1
        step = torch.ones_like(keys, dtype=torch.bool)
        step[1:] = keys[1:] != keys[:-1]
        with tracing.span("alp.fetch.distinct.unique"):
            unique = keys[step]
        del keys, step
        new = torch.ones_like(unique, dtype=torch.bool)
        for prev in seen:
            at = torch.searchsorted(prev, unique).clamp_(max=prev.shape[0] - 1)
            new &= prev[at] != unique
        with tracing.span("alp.fetch.distinct.new"):
            count += int(new.sum())
        seen.append(unique)
    return count


@tracing.spanned("alp.engine.groupby_keys")
def groupby_keys(kcol, device=None) -> tuple:
    """Dense GROUP-BY keys of a compressed column (``alp_tpu/engine.py
    :2984``): ``(keys, uniques)`` with ``uniques[keys[i]]`` the i-th value
    (NaNs one group): the column decoded on the device, then
    ``np.unique(..., return_inverse=True)`` on the host, as the JAX package
    does."""
    from .container import decompress
    vals = decompress(kcol, device)
    with tracing.span("alp.fetch.groupby_keys.values"):
        vals = vals.cpu().numpy()
    uniques, keys = np.unique(vals, return_inverse=True)
    return keys.astype(np.int64), uniques


@tracing.spanned("alp.engine.query_count_exceptions")
def query_count_exceptions(col) -> int:
    """The number of exceptions, from the metadata alone."""
    return int(np.asarray(col.exc_count, np.int64).sum())


@tracing.spanned("alp.engine.query_scan")
def query_scan(col, device=None) -> tuple:
    """SCAN: (the kept plan, its full decode [n_vectors, 1024] of values
    on the device), for downstream operators."""
    plan = col.plan(resolve_device(device))
    return plan, plan.run()


@tracing.spanned("alp.engine.query_compression")
def query_compression(data: np.ndarray, *, device=False) -> tuple:
    """COMPRESSION: (the compressed column, {"seconds",
    "throughput_gbps", "bits_per_value"}); ``device`` as in
    ``container.compress`` (False: on the host)."""
    import time

    from . import container
    t0 = time.perf_counter()
    cc = container.compress(data, device=device)
    dt = time.perf_counter() - t0
    return cc, {"seconds": dt, "throughput_gbps": data.nbytes / dt / 1e9,
                "bits_per_value": cc.bits_per_value()}


# ---------------------------------------------------------------------------
# Loop steps of the bench (alp_tpu/engine.py make_*_step)
# ---------------------------------------------------------------------------

class LoopStep:
    """A throughput step for ``benchlib.loop_bench``: ``step(carry, *args)``
    runs ``result(carry, *args)``, the device work with the carry folded
    into one input of every bucket, and returns ``fold(result, carry)``, a
    0-d int64 tensor on the plan's card that depends on the work's output
    and becomes the next carry.  At carry 0 nothing is perturbed, and
    ``answer(result)`` (where the step has one) turns the result into the
    answer of the query the step models."""

    def __init__(self, result, fold, answer=None):
        self.result = result
        self.fold = fold
        self.answer = answer

    def __call__(self, carry, *args):
        return self.fold(self.result(carry, *args), carry)


def carried(plan, carry: torch.Tensor):
    """A shallow copy of ``plan`` whose buckets take the loop's carry in
    one metadata input: an ALP bucket's FOR bases XORed with it (added at
    bit width 0, where an XOR chain would cancel: ``bench.py:86-95``), an
    ALP_RD bucket's dictionaries XORed with it.  The copy shares every
    other tensor, and the exception CSRs and ALP_RD scratch layout, which
    are built on ``plan`` first.  At carry 0 it decodes as ``plan``."""
    plan.exc_ptr, plan.rd_exc_ptr, plan._rd_layout    # built once, shared
    view = copy.copy(plan)
    buckets = []
    for b in plan.buckets:
        i = 1 if b.scheme == C.SCHEME_ALP else 2
        t = b.args[i]
        c = carry.to(t.dtype)
        t = t + c if b.scheme == C.SCHEME_ALP and b.bw == 0 else t ^ c
        buckets.append(dataclasses.replace(
            b, args=b.args[:i] + (t,) + b.args[i + 1:]))
    view.buckets = buckets
    return view


def _checksum(*parts) -> torch.Tensor:
    """int64 0-d: the sum of the parts' sums, floats by their bits."""
    total = None
    for p in parts:
        if p.is_floating_point():
            p = p.sum().to(torch.float32).view(torch.int32)
        t = p.sum().to(torch.int64)
        total = t if total is None else total + t
    return total


def make_sum_step(plan):
    """THROUGHPUT-TIMING step for a SUM-shaped query pipeline — NOT a SUM
    (``alp_tpu/engine.py:453``).  Returns ``(step, args)``; ``step(carry,
    *args)`` runs, for every f64 ALP bucket of bit width > 0, K20 (the
    decode fused with a per-lane float sum of the values cut to float by
    the reference's truncating convert), and for every other bucket (ALP_RD,
    f32, bit width 0) its decode (K1-K4, no exception patch) and
    ``torch.sum`` of the values rounded to float32, as the JAX step does.
    The carry perturbs the inputs, so the value is a checksum whose only
    purpose is the data dependence; :func:`query_sum` is the correct SUM.
    ``step.result`` gives the partials: [n, 16] floats a K20 bucket, a
    0-d float32 sum any other."""
    from .kernels import falp as kfalp
    rows = [torch.arange(b.n_vectors, device=plan.device)
            for b in plan.buckets]
    vdt = torch.float64 if plan.f64 else torch.float32

    def result(carry, plan):
        view = carried(plan, carry)
        parts = []
        for b, r in zip(view.buckets, rows):
            if plan.f64 and b.scheme == C.SCHEME_ALP and b.bw > 0:
                parts.append(kfalp.variant_sum_f64(b.args[0], b.bw,
                                                   *b.args[1:]))
                continue
            out = torch.empty((b.n_vectors, VECTOR_SIZE), dtype=vdt,
                              device=plan.device)
            view.launch(b, out, rows=r)
            parts.append(out.to(torch.float32).sum())
        return parts

    return LoopStep(result, lambda parts, carry: carry ^ _checksum(*parts)), (
        plan,)


def make_exact_sum_step(plan):
    """Throughput step for the EXACT-SUM pipeline (``alp_tpu/engine.py
    :509``): every SUM kernel call of :func:`exact_sum_totals` (K7/K8 on
    the ALP buckets; K3/K4, the exception scatter and K5/K6 on the ALP_RD
    ones), with the carry in their inputs.  ``step.result`` gives the int64
    [runs, W + 3] totals, ``exact_sum_totals(plan)`` at carry 0; the host
    join and rounding of :func:`query_sum` are left out."""

    def result(carry, plan):
        return exact_sum_totals(carried(plan, carry))

    return LoopStep(result, lambda t, carry: carry ^ _checksum(t),
                    lambda t: join_totals(t.tolist(), plan.dtype)), (plan,)


def _bins(plan, thresholds: torch.Tensor) -> torch.Tensor:
    """K15 over every bucket of ``plan`` into fresh int64 [E + 1] bins."""
    out = torch.zeros(thresholds.shape[0] + 1, dtype=torch.int64,
                      device=plan.device)
    for call in key_calls(plan):
        call.counts(thresholds, out)
    return out


def make_filter_step(plan, lo: float, hi: float):
    """Throughput step for the COUNT WHERE lo <= v <= hi pipeline
    (``alp_tpu/engine.py:545``; the column's dtype is the plan's): K15
    over every bucket at the thresholds of :func:`query_filter_count`, and
    the count from its bins on the card.  ``step.result`` gives the count,
    a 0-d int64 tensor, equal to :func:`query_filter_count` at carry 0."""
    klo, khi = _float_key(lo, plan.dtype), _float_key(hi, plan.dtype)
    want = np.array([klo - 1, khi] if klo else [khi], _key_type(plan.dtype))
    thr = np.unique(want)
    at = np.searchsorted(thr, want) if klo else None
    thr_t = _key_tensor(plan, thr)

    def result(carry, plan, thr_t):
        below = _bins(carried(plan, carry), thr_t).cumsum(0)
        if at is None:
            return below[0]
        return (below[at[1]] - below[at[0]]).clamp(min=0)

    return LoopStep(result, lambda c, carry: carry ^ c,
                    lambda c: int(c)), (plan, thr_t)


def make_topk_step(plan, k: int, largest: bool = True):
    """Throughput step for the TOP-K pipeline's scans (``alp_tpu/engine.py
    :1064``): K16 over every bucket (each vector's least and largest key),
    the k-th best vector key ``t`` (``torch.topk``), and K15 at the
    thresholds [t - 1, t] that count the ties; :func:`query_topk` adds the
    exact decode of the < k vectors beyond ``t``.  1 <= k <= n_vectors.
    ``step.result`` gives (``t`` as an unsigned key, 0-d in the bit
    patterns' dtype; the int64 [3] bins at [t - 1, t])."""
    k = int(k)
    if not 1 <= k <= plan.n_vectors or k > plan.n_values:
        raise ValueError(f"k must be in 1..{min(plan.n_vectors, plan.n_values)}")
    info = torch.iinfo(plan.bits_dtype)

    def work(biased):               # larger is better, for both orders
        return biased if largest else ~biased

    def result(carry, plan):
        view = carried(plan, carry)
        ext = bias(vector_extremes(view))
        vbest = work(ext[:, 1] if largest else ext[:, 0])
        t = bias(work(torch.topk(vbest, k).values[-1]))
        below = bias(bias(t).clamp(min=info.min + 1) - 1)
        return t, _bins(view, torch.stack([below, t]))

    return LoopStep(result, lambda r, carry: carry ^ _checksum(*r)), (plan,)


def make_histogram_step(plan, edges):
    """Throughput step for the HISTOGRAM pipeline (``alp_tpu/engine.py
    :1262``): K15 over every bucket at the thresholds of
    :func:`query_histogram`.  ``step.result`` gives the int64 bins;
    ``step.answer`` turns them into :func:`query_histogram`'s counts."""
    edges = [float(e) for e in edges]
    if len(edges) < 2 or any(a >= b for a, b in zip(edges, edges[1:])):
        raise ValueError("edges must be >= 2 strictly increasing values")
    kt = _key_type(plan.dtype)
    keys = _float_keys(edges, plan.dtype)
    khis = np.concatenate([keys - kt(1), keys[-1:]])
    uniq = np.unique(khis)
    at = np.searchsorted(uniq, khis)
    thr_t = _key_tensor(plan, uniq)

    def result(carry, plan, thr_t):
        return _bins(carried(plan, carry), thr_t)

    def answer(bins):
        return _histogram_counts(np.cumsum(bins.cpu().numpy())[:-1][at],
                                 len(edges))

    return LoopStep(result, lambda b, carry: carry ^ _checksum(b),
                    answer), (plan, thr_t)


def make_groupby_step(col, keys, num_groups: int, plan=None):
    """Throughput step for the GROUP-BY pipeline (``alp_tpu/engine.py
    :2995``): the device part of :func:`group_totals` with its kernels run
    anew each iteration.  Keys in non-decreasing order: K18 over every
    bucket, the prefix sums over the whole vectors and K19 over the
    vectors a boundary crosses; any other keys: K19 over the whole column.
    The keys are checked, laid out and uploaded once; the host join is left
    out.  ``plan`` defaults to ``col.plan()`` (the card).  ``step.answer``
    turns ``step.result`` into :func:`group_totals`'s :class:`Groups`."""
    keys = _checked_keys(col, keys, num_groups)
    if col.n_values == 0:
        raise ValueError("GROUP-BY step of an empty column")
    plan = col.plan() if plan is None else plan
    bounds = _key_bounds(keys, num_groups)
    if bounds is not None:
        lay = _ordered_layout(plan, bounds, _keys_of(keys, col.n_values))

        def result(carry, plan):
            view = carried(plan, carry)
            return _ordered_device(view, lay, *vector_sums(view))

        def answer(res):
            return _ordered_host(plan, lay, *res)

        def fold(res, carry):
            return carry ^ _checksum(*res[0], res[2])
        return LoopStep(result, fold, answer), (plan,)
    kv = _unordered_keys(plan, keys)

    def result(carry, plan):
        return group_reduce(carried(plan, carry), kv, num_groups)

    def fold(res, carry):
        return carry ^ _checksum(*res[0], res[1])
    return LoopStep(result, fold,
                    lambda res: _unordered_host(plan.dtype, *res)), (plan,)
