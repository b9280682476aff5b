"""The port's key kernels: wrappers, plain PyTorch versions, counts.

The three kernels decode one bucket of a plan (K1-K4's arguments), write each
vector's true exception bits in from the plan's per-vector CSR and skip
the pad of a partial last vector (position ``vec * 1024 + k >=
n_values``, with ``vec = rows[i]`` the vector id of row i); then they read
the IEEE-754 total-order key of every value (``ops.keys``):

    K15 key_counts    <- alp_tpu/kernels/falp.py falp_decode_f64_variant_
                         count, falp_decode_f64_count, falp_decode_f32_
                         count, rd_decode_dict_f64_count, rd_decode_dict_
                         f32_count and the four *_prefix_counts kernels
    K16 key_extremes  <- falp_decode_f64_variant_keymax, rd_decode_dict_
                         f64_keymax, falp_decode_f32_keymax,
                         rd_decode_dict_f32_keymax
    K17 rank_pass     <- falp_decode_f64_variant_rankpass, rd_decode_dict_
                         f64_rankpass, falp_decode_f32_rankpass,
                         rd_decode_dict_f32_rankpass

K15 adds into ``out``, int64 [E + 1] bins, one count a value at bin
``p = #{thresholds < key}``; ``thresholds`` are E ascending unsigned keys
(held in int64 for f64, int32 for f32), so ``#{key <= thresholds[e]}`` is
the sum of bins 0..e.  One launch takes at most ``MAX_THRESHOLDS``; the
wrapper launches longer lists in chunks, each chunk's counts standing
alone, and joins them into the same bins.  K16 writes the least and the
largest key of each vector into row ``rows[i]`` of ``out``, [N, 2] in the
bit patterns' dtype (unsigned keys in a signed dtype).  K17, one pass of
the quantile bisection, adds K15's bins at 1 to ``MAX_THRESHOLDS``
thresholds into ``bins`` and merges into ``mm`` [R, 2] (keys), for each of
1 to ``MAX_RANKS`` brackets ``brackets[r] = (lo, hi)`` (keys), the least
and the largest key in ``[lo, hi]``; ``rank_outputs`` makes the two
tensors, ``mm`` at (all ones, 0), which a bracket that holds no value of
the bucket leaves as it is.

Each scheme has one wrapper a kernel (``*_alp``: K1/K2's ``packed, bw,
base, fact, frac`` and the ALP exceptions' true bits; ``*_rd``: K3/K4's
``right, rbw, left, lbw, dictionary, dict_size`` and the ALP_RD
exceptions' raw left parts); the words' dtype picks f64 or f32.  A CUDA
tensor goes through the hand-written kernel in ``csrc/keys.cu`` on the
current stream of the tensors' card, its grid sized by that card's SM
count, without a synchronise; a CPU tensor goes through the plain version
beside it.  Counts and keys are integers: the kernels equal their plain
versions exactly.  ``LAUNCHES`` counts kernel launches per kernel; plain
runs do not count.

The three share one row loop (``for_each_row`` in ``csrc/vector.cuh``): a
block (256 threads for K17, 128 for K15 and K16) walks its rows of the
bucket, the next row's words staged with cp.async while the current one
is read, each thread's values of a vector decoded into registers and its
exceptions patched in by the thread that owns the slot, one barrier a
vector.  K15 takes one of two kernels, chosen inside the C entry by E:
at most 2 thresholds (``kSmall``: COUNT WHERE, TOP-K's tie count) are
compared with every key and counted in registers (no search, no shared
histogram); more walk K17's search tree and count into a shared
histogram.  K16 reduces a warp's keys with redux, and thread 0 merges the
4 warps' pairs after a second barrier.  What still holds each from its
bound (the row loop's exceptions and decode; the tree's random shared
reads) is in the head of ``csrc/keys.cu``.
"""

from __future__ import annotations

import torch

from .. import tracing
from ..ops.keys import bias, biased_keys
from .decode import patch_rd_exceptions
from .exact_sum import falp_bits_plain
from .falp import VECTOR_SIZE, _check, _device_kind, _launch, _ptr, rd_plain

MAX_THRESHOLDS = 2048           # csrc/keys.cu kMaxThr: a tree of 2047 + 1
MAX_RANKS = 8                   # csrc/keys.cu kMaxRanks: a register pair each
LAUNCHES = tracing.Counters("alp.launch.", (
    "key_counts", "key_extremes", "rank_pass"))
_WORDS = {torch.int64: ("f64", 64), torch.int32: ("f32", 32)}


reset_launches = LAUNCHES.reset


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rd_bits_plain(right, rbw, left, lbw, dictionary, dict_size, rows,
                  exc_ptr, exc_index, exc_left) -> torch.Tensor:
    """An ALP_RD bucket's bit patterns [n, 1024] with its exceptions in:
    K3/K4's plain glue, then each exception's left part above its right
    bits."""
    bits = rd_plain(right, rbw, left, lbw, dictionary, dict_size)
    patch_rd_exceptions(bits, rows, exc_ptr, exc_index, exc_left, rbw)
    return bits


def _valid(rows, n_values):
    pos = rows[:, None] * VECTOR_SIZE + torch.arange(VECTOR_SIZE,
                                                     device=rows.device)
    return pos < n_values


def _bins(keys, thresholds) -> torch.Tensor:
    """int64 [E + 1] bins of biased ``keys`` at unsigned ``thresholds``."""
    p = torch.searchsorted(bias(thresholds), keys)       # #{thr < key}
    return torch.bincount(p, minlength=thresholds.shape[0] + 1)


def counts_of_bits(bits, rows, n_values, thresholds) -> torch.Tensor:
    """Plain K15 over decoded bits: int64 [E + 1] bins."""
    return _bins(biased_keys(bits)[_valid(rows, n_values)], thresholds)


def extremes_of_bits(bits, rows, n_values) -> torch.Tensor:
    """Plain K16 over decoded bits: [n, 2] (least, largest) unsigned keys of
    each row's values that are not pad."""
    keys = biased_keys(bits)
    valid = _valid(rows, n_values)
    info = torch.iinfo(bits.dtype)
    lo = torch.where(valid, keys, info.max).amin(dim=1)
    hi = torch.where(valid, keys, info.min).amax(dim=1)
    return bias(torch.stack([lo, hi], dim=1))


def rank_pass_of_bits(bits, rows, n_values, thresholds, brackets) -> tuple:
    """Plain K17 over decoded bits: (K15's int64 [T + 1] bins, [R, 2] the
    least and the largest unsigned key in each bracket, (all ones, 0) where
    none lies in it)."""
    keys = biased_keys(bits)[_valid(rows, n_values)]
    info = torch.iinfo(keys.dtype)
    br = bias(brackets)
    pairs = []
    for r in range(br.shape[0]):
        inside = (keys >= br[r, 0]) & (keys <= br[r, 1])
        pairs.append(torch.stack([torch.where(inside, keys, info.max).amin(),
                                  torch.where(inside, keys, info.min).amax()]))
    return _bins(keys, thresholds), bias(torch.stack(pairs))


def rank_outputs(n_thresholds: int, n_ranks: int, dtype,
                 device) -> tuple:
    """K17's zeroed bins (int64 [T + 1]) and mm ([R, 2] keys in ``dtype``,
    each pair at (all ones, 0))."""
    mm = torch.zeros((n_ranks, 2), dtype=dtype, device=device)
    mm[:, 0] = -1
    return torch.zeros(n_thresholds + 1, dtype=torch.int64,
                       device=device), mm


def _merge_extremes(mm, pairs) -> None:
    """``mm`` [R, 2] (keys) <- (the least, the largest) of ``mm`` and
    ``pairs``, in unsigned order."""
    a, b = bias(mm), bias(pairs)
    mm.copy_(bias(torch.stack([torch.minimum(a[:, 0], b[:, 0]),
                               torch.maximum(a[:, 1], b[:, 1])], dim=1)))


def key_counts_alp_plain(packed, bw, base, fact, frac, rows, exc_ptr,
                         exc_index, exc_bits, n_values, thresholds):
    return counts_of_bits(falp_bits_plain(packed, bw, base, fact, frac,
                                          rows, exc_ptr, exc_index,
                                          exc_bits),
                          rows, n_values, thresholds)


def key_counts_rd_plain(right, rbw, left, lbw, dictionary, dict_size, rows,
                        exc_ptr, exc_index, exc_left, n_values, thresholds):
    return counts_of_bits(rd_bits_plain(right, rbw, left, lbw, dictionary,
                                        dict_size, rows, exc_ptr, exc_index,
                                        exc_left),
                          rows, n_values, thresholds)


def key_extremes_alp_plain(packed, bw, base, fact, frac, rows, exc_ptr,
                           exc_index, exc_bits, n_values):
    return extremes_of_bits(falp_bits_plain(packed, bw, base, fact, frac,
                                            rows, exc_ptr, exc_index,
                                            exc_bits), rows, n_values)


def key_extremes_rd_plain(right, rbw, left, lbw, dictionary, dict_size,
                          rows, exc_ptr, exc_index, exc_left, n_values):
    return extremes_of_bits(rd_bits_plain(right, rbw, left, lbw, dictionary,
                                          dict_size, rows, exc_ptr,
                                          exc_index, exc_left),
                            rows, n_values)


def rank_pass_alp_plain(packed, bw, base, fact, frac, rows, exc_ptr,
                        exc_index, exc_bits, n_values, thresholds, brackets):
    return rank_pass_of_bits(falp_bits_plain(packed, bw, base, fact, frac,
                                             rows, exc_ptr, exc_index,
                                             exc_bits),
                             rows, n_values, thresholds, brackets)


def rank_pass_rd_plain(right, rbw, left, lbw, dictionary, dict_size, rows,
                       exc_ptr, exc_index, exc_left, n_values, thresholds,
                       brackets):
    return rank_pass_of_bits(rd_bits_plain(right, rbw, left, lbw, dictionary,
                                           dict_size, rows, exc_ptr,
                                           exc_index, exc_left),
                             rows, n_values, thresholds, brackets)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_csr(exc_ptr, exc_index, exc_data, data_dtype, device):
    if exc_ptr.dim() != 1 or exc_ptr.shape[0] < 1:
        raise ValueError("exc_ptr must be [n_vectors + 1]")
    _check("exc_ptr", exc_ptr, torch.int64, exc_ptr.shape, device)
    n_exc = exc_index.shape[0]
    _check("exc_index", exc_index, torch.int64, (n_exc,), device)
    _check("exc_data", exc_data, data_dtype, (n_exc,), device)


def _check_alp(packed, bw, base, fact, frac, rows, exc_ptr, exc_index,
               exc_bits, n_values):
    """Validated (word dtype, n, device) of an ALP bucket's arguments."""
    wtype = packed.dtype
    if wtype not in _WORDS:
        raise TypeError(f"packed: int64 or int32 words, got {wtype}")
    S = _WORDS[wtype][1]
    ftype = torch.float64 if S == 64 else torch.float32
    n, device = packed.shape[0], packed.device
    if not 0 <= bw <= S:
        raise ValueError(f"bit width {bw} out of range 0..{S}")
    _check("packed", packed, wtype, (n, bw * (VECTOR_SIZE // S)), device)
    for nm, t, dt in (("base", base, wtype), ("fact", fact, wtype),
                      ("frac", frac, ftype), ("rows", rows, torch.int64)):
        _check(nm, t, dt, (n,), device)
    _check_csr(exc_ptr, exc_index, exc_bits, wtype, device)
    if n_values < 0:
        raise ValueError(f"n_values {n_values} is negative")
    return wtype, n, device


def _check_rd(right, rbw, left, lbw, dictionary, dict_size, rows, exc_ptr,
              exc_index, exc_left, n_values):
    """Validated (word dtype, n, device) of an ALP_RD bucket's arguments."""
    wtype = right.dtype
    if wtype not in _WORDS:
        raise TypeError(f"right: int64 or int32 words, got {wtype}")
    S = _WORDS[wtype][1]
    n, device = right.shape[0], right.device
    if not (0 <= rbw <= S and 0 <= lbw <= 16):
        raise ValueError(f"RD bit widths {rbw}/{lbw} out of range")
    _check("right", right, wtype, (n, rbw * (VECTOR_SIZE // S)), device)
    _check("left", left, torch.int16, (n, lbw * (VECTOR_SIZE // 16)), device)
    _check("dictionary", dictionary, torch.int16, (n, 8), device)
    _check("dict_size", dict_size, torch.int32, (n,), device)
    _check("rows", rows, torch.int64, (n,), device)
    _check_csr(exc_ptr, exc_index, exc_left, torch.int64, device)
    if n_values < 0:
        raise ValueError(f"n_values {n_values} is negative")
    return wtype, n, device


def _counts(scheme, args, n_values, thresholds, out):
    """K15 over one bucket (``args``: its arguments through ``exc_*``)."""
    check, plain = ((_check_alp, key_counts_alp_plain) if scheme == "alp"
                    else (_check_rd, key_counts_rd_plain))
    wtype, n, device = check(*args, n_values)
    E = thresholds.shape[0]
    if E < 1:
        raise ValueError("key_counts needs at least one threshold")
    _check("thresholds", thresholds, wtype, (E,), device)
    if out is None:
        out = torch.zeros(E + 1, dtype=torch.int64, device=device)
    _check("out", out, torch.int64, (E + 1,), device)
    if _device_kind(thresholds) == "cpu":
        out += plain(*args, n_values, thresholds)
        return out
    entry = f"key_counts_{scheme}_{_WORDS[wtype][0]}"
    ptrs = [a if isinstance(a, int) else _ptr(a) for a in args]
    if E <= MAX_THRESHOLDS:
        _launch(entry, device, *ptrs, n, n_values, _ptr(thresholds), E,
                _ptr(out), device.index)
        LAUNCHES["key_counts"] += 1
        return out
    # each chunk's bins give its own prefix counts #{key <= thr}; their
    # concatenation, differenced, is the bins of the whole list
    prefix = []
    for lo in range(0, E, MAX_THRESHOLDS):
        part = thresholds[lo:lo + MAX_THRESHOLDS]
        bins = torch.zeros(part.shape[0] + 1, dtype=torch.int64,
                           device=device)
        _launch(entry, device, *ptrs, n, n_values, _ptr(part),
                part.shape[0], _ptr(bins), device.index)
        LAUNCHES["key_counts"] += 1
        prefix.append(torch.cumsum(bins, 0))
    total = prefix[0][-1:]
    le = torch.cat([p[:-1] for p in prefix])
    out += torch.diff(le, prepend=le.new_zeros(1), append=total)
    return out


def _extremes(scheme, args, n_values, out):
    """K16 over one bucket into rows ``rows`` of ``out`` [N, 2]."""
    check, plain = ((_check_alp, key_extremes_alp_plain) if scheme == "alp"
                    else (_check_rd, key_extremes_rd_plain))
    wtype, n, device = check(*args, n_values)
    if out.dim() != 2 or out.shape[1] != 2:
        raise ValueError("out must be [N, 2]")
    _check("out", out, wtype, out.shape, device)
    rows = args[5] if scheme == "alp" else args[6]
    if _device_kind(rows) == "cpu":
        out[rows] = plain(*args, n_values)
        return out
    entry = f"key_extremes_{scheme}_{_WORDS[wtype][0]}"
    ptrs = [a if isinstance(a, int) else _ptr(a) for a in args]
    _launch(entry, device, *ptrs, n, n_values, _ptr(out), device.index)
    LAUNCHES["key_extremes"] += 1
    return out


def _rank_pass(scheme, args, n_values, thresholds, brackets, bins, mm):
    """K17 over one bucket, added into ``bins`` and merged into ``mm``."""
    check, plain = ((_check_alp, rank_pass_alp_plain) if scheme == "alp"
                    else (_check_rd, rank_pass_rd_plain))
    wtype, n, device = check(*args, n_values)
    T, R = thresholds.shape[0], brackets.shape[0]
    if not 1 <= T <= MAX_THRESHOLDS:
        raise ValueError(f"rank_pass takes 1..{MAX_THRESHOLDS} thresholds, "
                         f"got {T}")
    if not 1 <= R <= MAX_RANKS:
        raise ValueError(f"rank_pass takes 1..{MAX_RANKS} brackets, got {R}")
    _check("thresholds", thresholds, wtype, (T,), device)
    _check("brackets", brackets, wtype, (R, 2), device)
    _check("bins", bins, torch.int64, (T + 1,), device)
    _check("mm", mm, wtype, (R, 2), device)
    if _device_kind(thresholds) == "cpu":
        got_bins, got_mm = plain(*args, n_values, thresholds, brackets)
        bins += got_bins
        _merge_extremes(mm, got_mm)
        return bins, mm
    entry = f"rank_pass_{scheme}_{_WORDS[wtype][0]}"
    ptrs = [a if isinstance(a, int) else _ptr(a) for a in args]
    _launch(entry, device, *ptrs, n, n_values, _ptr(thresholds), T,
            _ptr(brackets), R, _ptr(bins), _ptr(mm), device.index)
    LAUNCHES["rank_pass"] += 1
    return bins, mm


@tracing.kernel
def key_counts_alp(packed, bw, base, fact, frac, rows, exc_ptr, exc_index,
                   exc_bits, n_values, thresholds, out=None):
    """K15 on an ALP bucket.  K1/K2's arguments (packed int64 [n, bw * 16]
    or int32 [n, bw * 32]; base, fact [n] of the same dtype; frac float
    [n]), rows (int64 [n] vector ids), the plan's ALP exception CSR
    (exc_ptr int64 [n_vectors + 1]; exc_index int64 flat positions and
    exc_bits patterns in the words' dtype), n_values, and E ascending
    unsigned keys in the words' dtype; adds into ``out`` (int64
    [E + 1])."""
    return _counts("alp", (packed, bw, base, fact, frac, rows, exc_ptr,
                           exc_index, exc_bits), n_values, thresholds, out)


@tracing.kernel
def key_counts_rd(right, rbw, left, lbw, dictionary, dict_size, rows,
                  exc_ptr, exc_index, exc_left, n_values, thresholds,
                  out=None):
    """K15 on an ALP_RD bucket: K3/K4's arguments, rows, the plan's RD
    exception CSR (exc_left: int64 raw left parts), n_values and the
    thresholds, as :func:`key_counts_alp`."""
    return _counts("rd", (right, rbw, left, lbw, dictionary, dict_size, rows,
                          exc_ptr, exc_index, exc_left), n_values,
                   thresholds, out)


@tracing.kernel
def key_extremes_alp(packed, bw, base, fact, frac, rows, exc_ptr,
                     exc_index, exc_bits, n_values, out):
    """K16 on an ALP bucket (K15's arguments without thresholds): writes
    (least key, largest key) of vector rows[i] into out[rows[i]], ``out``
    [N, 2] in the words' dtype."""
    return _extremes("alp", (packed, bw, base, fact, frac, rows, exc_ptr,
                             exc_index, exc_bits), n_values, out)


@tracing.kernel
def key_extremes_rd(right, rbw, left, lbw, dictionary, dict_size, rows,
                    exc_ptr, exc_index, exc_left, n_values, out):
    """K16 on an ALP_RD bucket, as :func:`key_extremes_alp`."""
    return _extremes("rd", (right, rbw, left, lbw, dictionary, dict_size,
                            rows, exc_ptr, exc_index, exc_left), n_values,
                     out)


@tracing.kernel
def rank_pass_alp(packed, bw, base, fact, frac, rows, exc_ptr, exc_index,
                  exc_bits, n_values, thresholds, brackets, bins, mm):
    """K17 on an ALP bucket: K15's arguments, then R brackets (int64 or
    int32 [R, 2] unsigned keys, lo and hi); adds the bins into ``bins``
    (int64 [T + 1]) and merges each bracket's least and largest key into
    ``mm`` ([R, 2] keys, from ``rank_outputs``)."""
    return _rank_pass("alp", (packed, bw, base, fact, frac, rows, exc_ptr,
                              exc_index, exc_bits), n_values, thresholds,
                      brackets, bins, mm)


@tracing.kernel
def rank_pass_rd(right, rbw, left, lbw, dictionary, dict_size, rows,
                 exc_ptr, exc_index, exc_left, n_values, thresholds,
                 brackets, bins, mm):
    """K17 on an ALP_RD bucket, as :func:`rank_pass_alp`."""
    return _rank_pass("rd", (right, rbw, left, lbw, dictionary, dict_size,
                             rows, exc_ptr, exc_index, exc_left), n_values,
                      thresholds, brackets, bins, mm)


# scheme -> kernel -> (wrapper, plain version); the plain versions take the
# wrappers' positional arguments without ``out`` (``bins``, ``mm``) and
# return the bins (K15), the [n, 2] keys of the bucket's rows (K16) or the
# bins and the [R, 2] keys of the bucket (K17)
KERNELS = {
    "alp": {"key_counts": (key_counts_alp, key_counts_alp_plain),
            "key_extremes": (key_extremes_alp, key_extremes_alp_plain),
            "rank_pass": (rank_pass_alp, rank_pass_alp_plain)},
    "rd": {"key_counts": (key_counts_rd, key_counts_rd_plain),
           "key_extremes": (key_extremes_rd, key_extremes_rd_plain),
           "rank_pass": (rank_pass_rd, rank_pass_rd_plain)},
}
