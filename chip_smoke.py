#!/usr/bin/env python3
"""Drive alp_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each printing its wall time:

1. env      the card's name and power limit (nvidia-smi).
2. build    the CUDA kernels (one nvcc call, sm_90a) and the host engine
            (g++ over native/alpcore.cpp), cold or cached.
3. compress columns generated from the seed, one per decode route: the
            five profiles of bench.py (bit widths ~0/11/20/30/42), an ALP
            column reaching bit widths 53-64, f64 ALP_RD, f32 ALP, f32
            ALP_RD, a mixed ALP/ALP_RD column, and one with NaN, +-Inf and
            -0.0 exceptions and a tail.  Each is compressed on the host
            over >= 10 rowgroups and carried through its ALPT bytes; the
            bench profiles are then tiled to 32,768 vectors (256 MiB of
            doubles) as bench.py does, and the f64 ALP_RD and both f32
            columns to 256 MiB of decoded values.
4. decode   ``alp_tpu_torch.decompress(col)`` on the card for every column
            (the main path: launch counts are set to 0 just before and
            read just after); the output's bits must equal the input's.
5. bench    the port's bench, the path of K20-K23 (their launch counts
            and K1's set to 0 just before and read just after):
            ``alp_tpu_torch.bench``'s headline on the five 256 MiB
            profiles (each profile's decode with the exception patch and
            its kernels alone, timed by ``benchlib.loop_bench``), printed
            as its JSON line ``{"metric": "falp_decode_f64_suite_avg",
            ...}``, then every row of ``alp_tpu_torch.bench_speed`` (K1,
            K2, K7, K9, K12, K16 and K20-K23 on their reference shapes, and
            the six loop steps on a 64 MiB column).  After each row that
            runs K20-K23 (``BENCH_ROWS``), its output on the row's own
            inputs is held against the plain version by bits (tolerance
            0; those launches are not counted).
6. sum      ``alp_tpu_torch.query_sum(col)`` on the card for every column
            (the SUM path, its launch counts set to 0 just before and read
            just after), twice: the first call builds and keeps the plan,
            the second reuses it.  Both must equal ``math.fsum`` of the
            input bit for bit.  ``query_mean`` on a column of the first
            97 vectors of each input must equal the exact rational mean
            rounded once.
7. query    the predicate and order queries on the card for every column
            (their launch counts set to 0 just before and read just
            after), each twice: the first call of the first query builds
            the plan again, the second call reuses it.  COUNT WHERE on two
            ranges, MIN, MAX, TOP-K with k = 1 and 128 in both orders (and
            k > n_vectors, the full decode, on the small columns),
            histograms of 16 and 4097 edges, and SUM WHERE on one range.
            Every answer must equal a numpy reference computed from the
            whole input by bits: counts and extremes of a sort of the
            input's total-order keys, ``np.searchsorted`` on it, and
            ``math.fsum`` of the selected values.  Prints each query's
            walls (host clock, ending in the answer on the host) and the
            K15/K16 and filtered K5-K8 launches.
8. quantile ``alp_tpu_torch.query_quantile`` at ten quantiles (0, 1e-6,
            0.001, 0.1, 0.25, 0.5, 0.75, 0.9, 0.999, 1) in each of the five
            methods, and ``query_median``, on the card for every column (the
            launch counts set to 0 just before and read just after), each
            twice: the first call builds the plan and keeps the key extent
            (K16), the second reuses both.  Every answer must equal
            ``np.quantile`` of the input (of its key-sorted copy from the
            query phase, which makes numpy's partition cheap) by bits, a zero
            by ``==`` (numpy returns either sign) and a NaN by ``isnan``.
            Prints the walls, the bisection passes and the K17 launches.
9. group    GROUP-BY, windows and DISTINCT on the card for every column
            (the launch counts set to 0 just before and read just after),
            each query twice (the first call builds the plan again, and
            K18's per-vector totals with it; the second reuses both):
            ``query_groupby`` with seeded random keys at G = 1, 16 and
            65,536 and with keys in 1,000 ordered runs of random length
            (K18's route), ``query_window`` tumbling at 102,400 rows (one
            rowgroup: no vector crossed) and 100,000 (every cell crosses
            one) and sliding at 409,600 by 102,400, ``query_distinct``, and
            ``groupby_keys`` of a small column grouping another.  Every
            answer must equal a numpy reference from the whole input by
            bits (NaN by ``isnan``): every group's count, least and largest
            value; every group's exact SUM and MEAN (``exact_totals``, apart
            from the port) and ``math.fsum`` on the small columns and at
            G <= 16, on up to 256 seeded groups or windows of at most 2 M
            values elsewhere; DISTINCT from the sorted keys of the query
            phase.  The groups' integer totals, as each call rounds them,
            must join to the column's exact total (``exact_sum_totals``).
            Prints the walls, each kept call's host finish and the K18/K19
            launches.
10. dcompress  ``alp_tpu_torch.compress_device`` on the card (the device
            compress path, its launch counts set to 0 just before and read
            just after) of every column: the f64 ones (the bench profiles
            and f64 ALP_RD at their full 256 MiB) with K9-K11, then f32 ALP
            and f32 ALP_RD as 256 MiB arrays (65,536 vectors) with
            K12-K14: the blob must equal host ``compress`` of the same
            array, and so must the blob of the round trip that stays on
            the card, ``compress_device(values=decompress(col),
            n_values=...)``.  Prints each column's device and host
            compress walls, launches and the bytes copied to the host.
11. kernels each kernel against its plain PyTorch version on the card, on
            the same plans, bit for bit (tolerance 0: the codec is
            lossless and the SUM totals are integers); K9-K14 on every
            call of a second ``compress_device`` of every column; K15 (17
            thresholds, and 2049 on one column: two launches a bucket) and
            K16 on every bucket of every column, K17 on every bucket of
            every column at the thresholds and brackets of a real first
            pass of the quantile bisection, K5-K8 with a key range on
            every SUM call, K18 and K19 (G = 16, 65,536 and 1,000 ordered
            runs) on every bucket of every column; K20 and K22 on every
            ALP bucket of every column (K20 on the f64 ones), K21 on every
            ALP_RD bucket (the right parts and the left parts of the
            decode with its exceptions in: it must give the decode back),
            K23 on the decoded bits of every f64 column.
12. timing  CUDA-event time of each kernel at the 256 MiB shapes (K9-K14:
            their launches as the wrappers made them, without the
            wrappers' synchronising range checks), beside
            its bound (the bytes it must move at 3.35 TB/s, or the
            operations its function needs at the card's rate, whichever
            is larger) and the plain version's time; as yardsticks, not
            the same function, a device-to-device ``copy_`` of the decoded
            bytes (decode kernels) and ``torch.sum`` of the decoded values
            (SUM kernels, rounded, not exact), a ``copy_`` of the bytes
            K9-K14 read; K15 (E = 2, COUNT, and E = 17) and K16 on the
            256 MiB columns, with ``torch.bucketize`` + ``torch.bincount``
            and ``amin``/``amax`` over the decoded keys as yardsticks, K17
            at R = 8 brackets and T = 2048 thresholds, twice: 8 disjoint
            brackets spanning the column, and a later bisection pass (8
            bands of 0.1 % of the column, the thresholds spread inside
            them), each with ``torch.bucketize`` + ``torch.bincount`` and
            a masked ``amin``/``amax`` a bracket as its yardstick and its
            bound by RANK_SEARCH and RANK_OPS beside the first design's
            count (RANK_ALL), the filtered
            K5-K8 beside the plain SUM, K18 with a row sum and
            ``amin``/``amax`` of the decoded values as its yardstick, and
            K19 at G = 16 and 65,536 random and at 16 ordered runs, with
            ``index_add_`` and
            ``scatter_reduce`` of the decoded values and keys by group as
            its yardstick; K20 on the five profiles (bound by VSUM_OPS),
            K21 on f64 and f32 ALP_RD, K22 on the profiles and f32 ALP, K23
            on the six 256 MiB f64 columns, each beside a ``copy_`` of as
            many bytes as it moves.  No PyTorch call decodes, encodes, packs or
            scores ALP, sums exactly or counts keys of the compressed form,
            so ``library_ms`` is null.

Then the nvidia-smi line, one JSON line with every kernel's numbers and,
last, ``{"ok": true, "device": {...}}``.  Any failure exits nonzero before
that line.  Without a CUDA device, or without the package beside this
file, it exits nonzero at once.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import json
import math
import multiprocessing
import os
import struct
import subprocess
import sys
import time
import types
from fractions import Fraction
from multiprocessing import shared_memory

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FLOPS_PER_S = 67e12              # H100 non-tensor float32 peak
INT32_LANES_PER_SM = 64          # Hopper: 4 sub-partitions x 16 INT32 lanes
VECTOR = 1024
ROWGROUP_VECTORS = 100
SOURCE_VECTORS = 10 * ROWGROUP_VECTORS
BENCH_VECTORS = 32 * 1024        # bench.py's TARGET_VECTORS: 256 MiB of f64
# columns tiled to 256 MiB of decoded values before they are decoded
TILE_TO = {"f64_alp_rd": BENCH_VECTORS, "f32_alp": 2 * BENCH_VECTORS,
           "f32_alp_rd": 2 * BENCH_VECTORS}
KERNELS = {
    "falp_decode_f64": ("alp_tpu/kernels/falp.py:143", [
        "alp_tpu/kernels/falp.py:230", "alp_tpu/kernels/falp.py:322",
        "alp_tpu/kernels/falp.py:394", "alp_tpu/kernels/falp.py:444",
        "alp_tpu/kernels/falp.py:1229"]),
    "falp_decode_f32": ("alp_tpu/kernels/falp.py:1336", []),
    "rd_decode_dict_f64": ("alp_tpu/kernels/falp.py:1470", []),
    "rd_decode_dict_f32": ("alp_tpu/kernels/falp.py:1530", []),
}
SUM_KERNELS = {
    "exact_sum_f64": "alp_tpu/kernels/falp.py:560",
    "exact_sum_f32": "alp_tpu/kernels/falp.py:654",
    "falp_decode_f64_exact_sum": "alp_tpu/kernels/falp.py:737",
    "falp_decode_f32_exact_sum": "alp_tpu/kernels/falp.py:689",
}
# Operations the exact SUM needs a value, counted from the algorithm and
# not from the kernels' design (their register windows, the warps' range
# checks and reductions are overhead of the design, not work of the
# function): 32-bit integer operations, a 64-bit add or shift counting
# two.  Every value: its exponent field (2) and the test for zero and the
# specials (2).  A nonzero finite value: the mantissa with its implicit bit
# (2), e_eff = max(e, 1) (1), window and shift (2), the digits of
# m' << shift (3 funnel shifts f64, 2 f32) and the signed add of each digit
# into its int64 window (2 each: 6 f64, 4 f32).  The fused decode (K7/K8)
# adds, every value, the FOR add and the wrapping FACT product (2 + 3 f64,
# 1 + 1 f32), at bit width > 0 the unpack of its field (4 f64, 2 f32), and
# two float operations (the integer-to-float conversion and the product).
SUM_OPS = {  # kernel -> (every value, nonzero finite value, unpack, float)
    "exact_sum_f64": (4, 14, 0, 0), "exact_sum_f32": (4, 11, 0, 0),
    "falp_decode_f64_exact_sum": (9, 14, 4, 2),
    "falp_decode_f32_exact_sum": (6, 11, 2, 2)}
FP64_FLOPS_PER_S = 34e12         # H100 SXM FP64 outside the tensor cores
FP64_LANES_PER_SM = 64           # Hopper: 4 sub-partitions x 16 FP64 lanes
FP32_LANES_PER_SM = 128          # Hopper: 4 sub-partitions x 32 FP32 lanes
MEAN_VECTORS = 97                # query_mean columns: <= 99,328 values
DC_TIMED = ("bench_bw11_city_temperature", "bench_bw20_food_prices",
            "bench_bw30_bitcoin", "bench_bw42_nyc29", "bench_bw0_gov26",
            "f64_alp_rd")          # the 256 MiB f64 columns
DC_TIMED32 = ("f32_alp", "f32_alp_rd")   # the 256 MiB f32 columns
# device compress kernels: launch-count key -> (source, TPU site, others,
# the columns it is timed on)
DC_KERNELS = {
    "score_pairs_f64": ("alp_tpu_torch/csrc/score.cu",
                        "alp_tpu/kernels/score.py:533",
                        ["alp_tpu/kernels/score.py:223"], DC_TIMED),
    "alp_encode_f64": ("alp_tpu_torch/csrc/encode.cu",
                       "alp_tpu/kernels/encode.py:402",
                       ["alp_tpu/kernels/encode.py:319"], DC_TIMED),
    "ffor_pack_f64": ("alp_tpu_torch/csrc/ffor.cu",
                      "alp_tpu/kernels/falp.py:2605", [], DC_TIMED),
    "score_pairs_f32": ("alp_tpu_torch/csrc/score.cu",
                        "alp_tpu/kernels/score.py:498", [], DC_TIMED32),
    "alp_encode_f32": ("alp_tpu_torch/csrc/encode.cu",
                       "alp_tpu/kernels/encode.py:238",
                       ["alp_tpu/kernels/encode.py:165"], DC_TIMED32),
    "ffor_pack_f32": ("alp_tpu_torch/csrc/ffor.cu",
                      "alp_tpu/kernels/falp.py:2635", [], DC_TIMED32),
}
# Operations K9-K14 need, counted from the algorithm (32-bit integer
# operations, a 64-bit one counting two; float operations, each issued
# once).  One encode + verify of a value (K9) or a trial (K11): FP64 the
# two products of the scale, the magic add and subtract, the two
# compares of the cast's range test, the cast, the int -> double and
# the product by 10^-e (9); integer the wrapping 64-bit product n * FACT
# (3) and the 64-bit comparison of the decoded bits (2).  K9 adds the
# special test (4), the select of the replaced value (2) and the flag
# (1); with its stats the min and max over the non-exceptions (2 x 4),
# the count and the first index (2).  K11 adds the two FP64 compares with
# +-ENCODING_UPPER_LIMIT and the test of s's exponent and of -0.0 (4
# integer), then the min, max and count of each trial (9 integer) and
# 5 integer a (segment, pair) for the bit length and the estimate.  K10
# a value: the patch select (2), the wrapping subtract of the base (2),
# the mask (2) and the shifts and or into its one or two words (4).
# The f32 twins: one encode + verify (K12) or trial (K14) is FP32 the two
# products, the magic add and subtract, the two range compares, the cast,
# the int -> float, the product by 10^-e and the float comparison of the
# decode (10); integer the 32-bit product n * FACT (1).  K12 adds the
# special test (2), the select (1) and the flag (1); with its stats the
# min, max, count and first index (4).  K14 adds the float -> double of s
# and its two FP64 compares with +-ENCODING_UPPER_LIMIT (3 FP64), the
# tests for not finite and -0.0 (2), the select of INT32_MIN (1), then
# the min, max and count (3), and 5 a (segment, pair).  K13 a value: the
# patch select, the subtract, the mask (1 each) and the shifts and or into
# its one or two words (4).
DC_OPS = {  # per value or trial: (FP64, FP32, integer), stats/pair extra
    "alp_encode_f64": (9, 0, 12, 10), "score_pairs_f64": (11, 0, 18, 5),
    "ffor_pack_f64": (0, 0, 10, 0),
    "alp_encode_f32": (0, 10, 5, 4), "score_pairs_f32": (3, 10, 7, 5),
    "ffor_pack_f32": (0, 0, 7, 0)}
# key kernels: launch-count key -> (TPU site, the other sites it replaces)
KEY_KERNELS = {
    "key_counts": ("alp_tpu/kernels/falp.py:890", [
        "alp_tpu/kernels/falp.py:1190", "alp_tpu/kernels/falp.py:1299",
        "alp_tpu/kernels/falp.py:1578", "alp_tpu/kernels/falp.py:2353",
        "alp_tpu/kernels/falp.py:1112", "alp_tpu/kernels/falp.py:1677",
        "alp_tpu/kernels/falp.py:1788", "alp_tpu/kernels/falp.py:1881"]),
    "key_extremes": ("alp_tpu/kernels/falp.py:1052", [
        "alp_tpu/kernels/falp.py:1624", "alp_tpu/kernels/falp.py:1746",
        "alp_tpu/kernels/falp.py:1830"]),
}
# Operations K15/K16 need a value, counted from the algorithm (32-bit
# integer operations, a 64-bit one counting two; float operations issued
# once).  The decode: ALP as SUM_OPS counts it for K7/K8 (the FOR add and
# FACT product, 5 f64 / 2 f32; the unpack at bw > 0, 4 / 2; two float
# operations), ALP_RD the unpack of the right part at rbw > 0 (4 / 2) and
# of the dictionary index at lbw > 0 (2), the clamp and dictionary read
# (2) and the glue, a shift and an or (4 / 2).  Then the key: the -0.0
# test, the sign test and the complement or the or (6 / 3).  K15: a
# compare a search step (2 / 1), ceil(log2(E + 1)) steps, and the count
# (1); K16: the two compares with the least and the largest key (4 / 2).
KEY_OPS = {  # f64 -> (ALP every, unpack, RD every, RD right unpack, key,
             #         compare)
    True: (5, 4, 6, 4, 6, 2), False: (2, 2, 4, 2, 3, 1)}
# K17: launch-count key -> (TPU site, the other sites it replaces)
RANK_KERNELS = {
    "rank_pass": ("alp_tpu/kernels/falp.py:2100", [
        "alp_tpu/kernels/falp.py:2160", "alp_tpu/kernels/falp.py:2238",
        "alp_tpu/kernels/falp.py:2295"]),
}
# Operations K17 needs beyond the decode and the key of KEY_OPS, counted
# from its algorithm on this run's data (RANK_SEARCH, RANK_OPS; compares
# count as KEY_OPS counts them: 2 for a 64-bit key, 1 for 32).  The search,
# as K15's: a compare a step, ceil(log2(T + 1)) steps, and the count (1).
# The brackets: the test against their union [min lo, max hi] (2
# compares); a key inside reads its bin's first cut interval and that
# interval's bracket mask (2 operations), compares itself with each cut
# that splits its bin (1 compare each: a later pass's bins between two
# brackets hold two; the cuts are lo - 1 and hi of the distinct
# brackets, and every interval between two cuts lies wholly inside or
# outside each bracket), and takes a min and a max for each bracket that
# holds it (2 compares).  RANK_ALL is the count of the first design: the
# same search, two compares of every value with the ends of each of the R
# brackets, a min and a max for each (value, bracket) pair where the
# value lies inside.
RANK_SEARCH = (1, 1)             # (a compare a step, the count)
RANK_ALL = (2, 2)                # first design: (a value and bracket, a
                                 #  value inside one)
RANK_OPS = (2, 2, 1, 2)          # (union test compares, a value inside it,
                                 #  a value and a cut splitting its bin, a
                                 #  value inside a bracket)
RANK_TIMED = (8, 2048)           # (R, T) of K17's timing rows
RANK_BAND = 1e-3                 # the later-pass row: a bracket's share
QUANTILE_QS = (0.0, 1e-6, 0.001, 0.1, 0.25, 0.5, 0.75, 0.9, 0.999, 1.0)
# K18/K19: launch-count key -> the TPU site it replaces (None: no site)
GROUP_KERNELS = {"vector_sum_extremes": "alp_tpu/kernels/falp.py:2046",
                 "group_reduce": None}
# the bench's kernels K20-K23: launch-count key -> (source, TPU site)
BENCH_KERNELS = {
    "variant_sum_f64": ("alp_tpu_torch/csrc/falp.cu",
                        "alp_tpu/kernels/falp.py:933"),
    "rd_glue_f64": ("alp_tpu_torch/csrc/falp.cu",
                    "alp_tpu/kernels/falp.py:1388"),
    "rd_glue_f32": ("alp_tpu_torch/csrc/falp.cu",
                    "alp_tpu/kernels/falp.py:2392"),
    "unffor": ("alp_tpu_torch/csrc/ffor.cu", "alp_tpu/kernels/falp.py:2455"),
    "key_extremes_bits": ("alp_tpu_torch/csrc/group.cu",
                          "alp_tpu/kernels/falp.py:1998"),
}
# bench_speed rows whose K20-K23 output the bench phase holds against the
# plain version on the row's own inputs: row name -> launch-count key
BENCH_ROWS = {"unffor_f64_bw16": "unffor", "unffor_f64_bw52": "unffor",
              "unffor_f32_bw30": "unffor",
              "rd_decode_f64_rbw52": "rd_glue_f64",
              "rd_decode_f32_rbw24": "rd_glue_f32",
              "falp_sum_fused_f64_bw16": "variant_sum_f64",
              "e2e_sum_query_64MiB": "variant_sum_f64",
              "key_extremes_bits_f64": "key_extremes_bits"}
# Operations K20 needs a value, counted from the algorithm as SUM_OPS
# counts K7's decode: integer the FOR add and the wrapping FACT product
# (2 + 3), the unpack of its field at bit width > 0 (4) and the truncating
# convert (8: the sign, the exponent's shift, mask, rebase and two clamps,
# the mantissa's two shifts and or, counted as 8 with the final ors);
# FP64 the integer-to-double conversion and the product (2); FP32 the add
# into the lane's sum (1).
VSUM_OPS = {"every": 13, "unpack": 4, "fp64": 2, "fp32": 1}
GROUP_SIZES = (1, 16, 65536)     # GROUP-BY with random keys
ORDERED_RUNS = 1000              # GROUP-BY with keys in runs: K18's route
TUMBLING = (102400, 100000)      # one rowgroup (no vector crossed), and not
SLIDING = (409600, 102400)       # (window, hop)
GROUP_SAMPLES = 256              # groups checked where not every one is,
SAMPLE_VALUES = 2 << 20          # at most this many values of them
METHODS = ("linear", "lower", "higher", "midpoint", "nearest")
QUERY_SMALL_K = 7                # TOP-K at n_vectors + 7 on small columns
DC_WRAPPERS = {  # launch-count key -> (module holding it, plain version)
    "alp_encode_f64": ("dc", "encode_plain"),
    "alp_encode_f32": ("dc", "encode_plain_f32"),
    "ffor_pack_f64": ("dc", "ffor_plain"), "ffor_pack_f32": ("dc", "ffor_plain"),
    "score_pairs_f64": ("kscore", "score_plain"),
    "score_pairs_f32": ("kscore", "score_plain_f32")}


def phase(name: str, t0: float, detail: str = "") -> None:
    print(f"[{name}] {time.perf_counter() - t0:.3f} s {detail}".rstrip(),
          flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=csv,noheader,nounits" if "clocks" in query
         else "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def same_float(a: float, b: float) -> bool:
    """Equal bits (NaN: both NaN)."""
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return struct.pack("<d", a) == struct.pack("<d", b)


def special_answer(x: np.ndarray):
    """The IEEE answer of SUM/MEAN over NaN or infinities, else None."""
    pinf, ninf = bool(np.isposinf(x).any()), bool(np.isneginf(x).any())
    if np.isnan(x).any() or (pinf and ninf):
        return float("nan")
    if pinf or ninf:
        return float("inf") if pinf else float("-inf")
    return None


def fsum_reference(x: np.ndarray) -> float:
    """math.fsum of the values (which refuses +Inf with -Inf)."""
    answer = special_answer(x)
    return answer if answer is not None else math.fsum(
        x.astype(np.float64).tolist())


def exact_mean_reference(x: np.ndarray) -> float:
    """The exact rational mean rounded once: every value as an integer
    times a power of two (np.frexp), summed in Python integers."""
    answer = special_answer(x)
    if answer is not None:
        return answer
    m, e = np.frexp(x.astype(np.float64))
    digits = (m * 2.0 ** 53).astype(np.int64).tolist()
    powers = (e.astype(np.int64) - 53).tolist()
    low = min(powers)
    total = sum(d << (p - low) for d, p in zip(digits, powers))
    return float(Fraction(total, len(x)) * Fraction(2) ** low)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def kernel_of(plan, bucket) -> str:
    kind = "falp_decode" if bucket.scheme == 2 else "rd_decode_dict"
    return f"{kind}_{'f64' if plan.f64 else 'f32'}"


def bits_view(t):
    import torch
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def run_plain(plan, bucket, out) -> None:
    """The bucket through its kernel's plain PyTorch version."""
    from alp_tpu_torch.kernels import falp
    if bucket.scheme == 2:
        vals = falp.falp_plain(bucket.args[0], bucket.bw, *bucket.args[1:])
        out[bucket.rows] = vals
    else:
        right, left, dictionary, dict_size = bucket.args
        bits_view(out)[bucket.rows] = falp.rd_plain(
            right, bucket.bw, left, bucket.lbw, dictionary, dict_size)


def bucket_bytes(bucket, value_size: int) -> int:
    """Bytes the decode of a bucket must move: every input read once
    (packed words, metadata, output rows), every value written once."""
    read = sum(t.numel() * t.element_size() for t in bucket.args)
    read += bucket.rows.numel() * bucket.rows.element_size()
    return read + bucket.n_vectors * VECTOR * value_size


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def call_bytes(plan, call) -> int:
    """Bytes a SUM kernel call must move: every input read once (for K7/K8
    the packed words, metadata, row ids, the exception CSR's entries of its
    vectors and their exceptions), the totals written once."""
    import torch
    from alp_tpu_torch.kernels import exact_sum as kes
    out = (kes.WINDOWS[plan.bits_dtype] + 3) * 8
    if not call.kernel.startswith("falp"):
        return sum(nbytes(a) for a in call.args
                   if isinstance(a, torch.Tensor)) + out
    packed, _, base, fact, frac, rows = call.args[:6]
    n_exc = int((plan.exc_ptr[rows + 1] - plan.exc_ptr[rows]).sum())
    return (sum(nbytes(t) for t in (packed, base, fact, frac, rows))
            + (rows.numel() + 1) * 8
            + n_exc * (8 + plan.exc_bits.element_size()) + out)


def sum_ops(plan, call, bits) -> tuple:
    """(values summed, integer operations, float operations) that one SUM
    kernel call needs on this run's data: SUM_OPS by value, the nonzero
    finite values counted in the decoded ``bits`` [n_vectors, 1024] of the
    column."""
    import torch
    every, digits, unpack, flops = SUM_OPS[call.kernel]
    rows = call.rows
    pos = rows[:, None] * VECTOR + torch.arange(VECTOR, device=rows.device)
    valid = pos < plan.n_values
    b = bits[rows]
    exp_bits, man_bits = (11, 52) if plan.f64 else (8, 23)
    finite = ((b >> man_bits) & ((1 << exp_bits) - 1)) != (1 << exp_bits) - 1
    nonzero = valid & finite & ((b << 1) != 0)
    n_valid, n_nonzero = int(valid.sum()), int(nonzero.sum())
    per_value = every + (unpack if call.bw else 0)
    return n_valid, n_valid * per_value + n_nonzero * digits, n_valid * flops


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    import torch
    if torch.equal(bits_view(a), bits_view(b)):
        return 0.0
    diff = (a.double() - b.double()).abs()
    return float(diff.nan_to_num(nan=float("inf")).max())


# ---------------------------------------------------------------------------
# query (K15, K16, filtered K5-K8) helpers and the numpy references
# ---------------------------------------------------------------------------

def np_keys(x: np.ndarray) -> np.ndarray:
    """The IEEE-754 total-order keys of values (-0.0 as +0.0): unsigned
    order on keys is -NaN < -Inf < finite < +Inf < +NaN."""
    b = x.view(f"u{x.dtype.itemsize}")
    sbit = b.dtype.type(1) << b.dtype.type(8 * b.itemsize - 1)
    b = np.where(b == sbit, b.dtype.type(0), b)
    return np.where((b & sbit) != 0, ~b, b | sbit)


def key_of(v: float, dtype) -> int:
    """The key of a bound, rounded to the column dtype first."""
    return int(np_keys(np.array([v], dtype))[0])


def values_of_keys(keys: np.ndarray, dtype) -> np.ndarray:
    """Values of unsigned keys; an f32 value through a double (so a
    signaling NaN comes out quiet, as TOP-K returns it)."""
    sbit = keys.dtype.type(1) << keys.dtype.type(8 * keys.itemsize - 1)
    bits = np.where((keys & sbit) != 0, keys ^ sbit, ~keys)
    vals = bits.view(dtype)
    return (vals.astype(np.float64).astype(np.float32)
            if np.dtype(dtype) == np.float32 else vals)


def query_references(x: np.ndarray, keys: np.ndarray, n_vectors: int,
                     small: bool) -> list:
    """The queries of the query phase and their numpy answers from the
    whole input (``keys``: its sorted total-order keys): [(label,
    call(package, column), answer, kind)]."""
    n = len(keys)
    kt = keys.dtype.type

    def val(i):
        return float(values_of_keys(keys[i:i + 1], x.dtype)[0])

    def count(lo, hi):
        klo, khi = kt(key_of(lo, x.dtype)), kt(key_of(hi, x.dtype))
        if klo > khi:
            return 0
        return int(np.searchsorted(keys, khi, "right")
                   - np.searchsorted(keys, klo, "left"))

    refs = []
    for lo, hi in ((val(n // 5), val(3 * n // 5)), (-0.0, val(9 * n // 10))):
        refs.append((f"filter_count[{lo!r}, {hi!r}]",
                     lambda q, c, lo=lo, hi=hi: q.query_filter_count(c, lo,
                                                                     hi),
                     count(lo, hi), "int"))
    refs.append(("min", lambda q, c: q.query_min(c),
                 float(values_of_keys(keys[:1], x.dtype)[0]), "float"))
    refs.append(("max", lambda q, c: q.query_max(c),
                 float(values_of_keys(keys[-1:], x.dtype)[0]), "float"))
    for k in [1, 128] + ([n_vectors + QUERY_SMALL_K] if small else []):
        for largest in (True, False):
            pick = keys[::-1][:k] if largest else keys[:k]
            refs.append((f"topk[k={k}, largest={largest}]",
                         lambda q, c, k=k, lg=largest: q.query_topk(c, k,
                                                                    lg),
                         values_of_keys(np.ascontiguousarray(pick),
                                        x.dtype), "array"))
    fin = x[np.isfinite(x)]
    for n_edges in (16, 4097):
        edges = np.linspace(float(fin.min()) - 1, float(fin.max()) + 1,
                            n_edges)
        ek = np.array([key_of(e, x.dtype) for e in edges], keys.dtype)
        left = np.searchsorted(keys, ek, "left")
        want = np.diff(left)
        want[-1] += np.searchsorted(keys, ek[-1], "right") - left[-1]
        refs.append((f"histogram[{n_edges} edges]",
                     lambda q, c, e=edges: q.query_histogram(c, e), want,
                     "array"))
    lo, hi = val(n // 2), val(6 * n // 10)
    k = np_keys(x)
    sel = x[(k >= kt(key_of(lo, x.dtype))) & (k <= kt(key_of(hi, x.dtype)))]
    refs.append((f"filter_sum[{lo!r}, {hi!r}]",
                 lambda q, c: q.query_filter_sum(c, lo, hi),
                 x.dtype.type(fsum_reference(sel)), "float"))
    return refs


def same_answer(got, want, kind) -> bool:
    if kind == "int":
        return int(got) == want
    if kind == "float":
        return same_float(float(got), float(want)) and (
            not isinstance(want, np.generic) or type(got) is type(want))
    return (isinstance(got, np.ndarray) and got.dtype == want.dtype
            and got.shape == want.shape and np.array_equal(
                got.view(f"u{got.itemsize}") if got.dtype.kind == "f"
                else got, want.view(f"u{want.itemsize}")
                if want.dtype.kind == "f" else want))


def same_quantile(got, want, dtype) -> bool:
    """A QUANTILE answer against numpy's in the column dtype: by bits, a
    zero by ``==`` (numpy returns whichever zero its partition meets), a
    NaN by ``isnan``; the dtype and shape must agree."""
    got, want = np.asarray(got), np.asarray(want).astype(dtype)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    nan, zero = np.isnan(want), want == 0
    rest = ~nan & ~zero
    return (np.array_equal(np.isnan(got), nan)
            and bool(np.all(got[zero] == 0))
            and np.array_equal(got[rest].view(f"u{got.itemsize}"),
                               want[rest].view(f"u{want.itemsize}")))


def column_thresholds(x: np.ndarray, n: int) -> np.ndarray:
    """n ascending distinct unsigned keys: evenly spaced keys of a sample of
    the column's values, the rest spread over the key space."""
    sample = np.unique(np_keys(x[::max(1, len(x) // 4096)]))
    picked = sample[np.linspace(0, len(sample) - 1,
                                min(n, len(sample))).astype(np.int64)]
    step = np.uint64(np.iinfo(sample.dtype).max // (2 * n + 1))
    spread = (np.arange(1, 2 * n + 1, dtype=np.uint64) * step).astype(
        sample.dtype)
    keys = np.unique(picked)
    for k in spread:
        if len(keys) >= n:
            break
        keys = np.union1d(keys, [k])
    return keys[:n]


def thresholds_tensor(keys: np.ndarray, plan):
    """Unsigned keys as the signed words K15 takes, on the plan's card."""
    import torch
    return torch.from_numpy(keys.view(f"i{keys.itemsize}").copy()).to(
        plan.device)


def rank_passes(engine, package, col) -> list:
    """The (thresholds, [R, 2] brackets) of every K17 pass that
    ``query_quantile(col, QUANTILE_QS)`` makes, unsigned numpy keys."""
    seen = []
    real = engine.rank_pass_bins

    def capture(plan, thresholds, brackets):
        kt = np.uint64 if plan.f64 else np.uint32
        seen.append((np.array(thresholds, kt),
                     np.array(brackets, kt).reshape(-1, 2)))
        return real(plan, thresholds, brackets)

    engine.rank_pass_bins = capture
    try:
        package.query_quantile(col, QUANTILE_QS)
    finally:
        engine.rank_pass_bins = real
    return seen


def disjoint_brackets(x: np.ndarray, R: int) -> np.ndarray:
    """[R, 2] disjoint brackets of unsigned keys: R pairs of evenly spaced
    keys of a sample of the column's values."""
    sample = np.unique(np_keys(x[::max(1, len(x) // 4096)]))
    return sample[np.linspace(0, len(sample) - 1, 2 * R).astype(
        np.int64)].reshape(R, 2)


def bracket_hits(plan, bk, brackets):
    """Int64 [n_vectors]: the (value, bracket) pairs of each vector whose
    value lies inside the bracket, from ``bk`` the column's biased keys and
    ``brackets`` biased [R, 2] (K17's min and max work)."""
    import torch
    hits = torch.zeros(plan.n_vectors * VECTOR, dtype=torch.int64,
                       device=bk.device)
    for lo, hi in brackets:
        hits[:bk.numel()] += ((bk >= lo) & (bk <= hi)).to(torch.int64)
    return hits.view(plan.n_vectors, VECTOR).sum(1)


def rank_work(plan, bk, thr: np.ndarray, brackets: np.ndarray) -> tuple:
    """K17's operations beyond the decode and the key on this run's data,
    int64 [n_vectors] (RANK_SEARCH and RANK_OPS), and the (value, cut)
    pairs of the whole column whose cut splits the value's bin, from the
    column's biased keys ``bk`` and the unsigned ``thr`` and ``brackets``
    ([R, 2])."""
    import torch
    cmp = KEY_OPS[plan.f64][5]
    flip = 1 << (8 * thr.itemsize - 1)
    top, bottom = (1 << (8 * thr.itemsize)) - 1, 0
    uniq = {(int(lo), int(hi)) for lo, hi in brackets if lo <= hi}
    cuts = sorted({c for lo, hi in uniq for c, keep in
                   ((lo - 1, lo > bottom), (hi, hi < top)) if keep})
    key = bk.to(torch.int64)
    bthr = torch.tensor([int(t) - flip for t in thr], device=bk.device)
    p = torch.searchsorted(bthr, key)
    ct = torch.tensor([c - flip for c in cuts], dtype=torch.int64,
                      device=bk.device)
    # bin b holds the keys in (thr[b - 1], thr[b]]: the cuts splitting it
    lower = torch.cat([bthr.new_full((1,), bottom - flip), bthr + 1])
    upper = torch.cat([bthr, bthr.new_full((1,), top - flip)])
    split = torch.searchsorted(ct, upper) - torch.searchsorted(ct, lower)
    ulo = min((lo for lo, _ in uniq), default=top) - flip
    uhi = max((hi for _, hi in uniq), default=bottom) - flip
    inside_u = (key >= ulo) & (key <= uhi)
    hits = torch.zeros_like(key)
    for lo, hi in uniq:
        hits += ((key >= lo - flip) & (key <= hi - flip)).to(torch.int64)
    ops = (RANK_SEARCH[0] * math.ceil(math.log2(len(thr) + 1)) * cmp
           + RANK_SEARCH[1] + RANK_OPS[0] * cmp
           + inside_u * (RANK_OPS[1] + split[p] * RANK_OPS[2] * cmp)
           + hits * RANK_OPS[3] * cmp)
    per = torch.zeros(plan.n_vectors * VECTOR, dtype=torch.int64,
                      device=bk.device)
    per[:key.numel()] = ops
    return (per.view(plan.n_vectors, VECTOR).sum(1),
            int((inside_u * split[p]).sum()))


def later_pass_case(sorted_bk, R: int, T: int) -> tuple:
    """(unsigned thresholds, [R, 2] unsigned brackets) of a later bisection
    pass, from ``sorted_bk`` the column's biased keys in order: R brackets,
    each a narrow band of RANK_BAND of the column around the (r + 1/2) / R
    quantile, and up to T thresholds spread evenly in key space inside
    them, as ``_rank_bisect`` places its key-space probes after its first
    pass."""
    n = sorted_bk.numel()
    width = max(1, int(n * RANK_BAND))
    flip = 1 << (8 * sorted_bk.element_size() - 1)
    at = [min(int((r + 0.5) / R * n), n - 1 - width) for r in range(R)]
    # a biased key plus 2^(bits - 1) is the unsigned key
    bands = [(int(sorted_bk[a]) + flip, int(sorted_bk[a + width]) + flip)
             for a in at]
    per = T // R
    ut = np.uint64 if sorted_bk.element_size() == 8 else np.uint32
    thr = np.unique(np.array([lo + (hi - lo) * (j + 1) // (per + 1)
                              for lo, hi in bands for j in range(per)], ut))
    return thr, np.array(bands, ut)


def valid_values(plan, rows) -> int:
    """Values of vectors ``rows`` that are not the pad."""
    last = plan.n_vectors - 1
    pad = plan.n_vectors * VECTOR - plan.n_values
    return rows.numel() * VECTOR - (pad if bool((rows == last).any())
                                    else 0)


def key_work(plan, call, E, R=0, hits=None, rank=None) -> tuple:
    """(bytes, integer operations, float operations) one K15 (E
    thresholds), K16 (E None) or K17 (E thresholds, R brackets) call needs
    on this run's data: its inputs read once (packed words, metadata, row
    ids, the CSR entries of its vectors and their exceptions, the
    thresholds and brackets), its outputs written once, KEY_OPS a value
    and, for K17, the [n_vectors] operations of ``rank_work`` or, without
    them, the first design's count (RANK_ALL, ``hits`` the [n_vectors]
    counts of ``bracket_hits``)."""
    every, unpack, rd_every, rd_unpack, key, cmp = KEY_OPS[plan.f64]
    w = 8 if plan.f64 else 4
    tensors = [a for a in call.args if hasattr(a, "numel")]
    ptr, exc_data = tensors[-3], tensors[-1]
    rows = call.rows
    n_exc = int((ptr[rows + 1] - ptr[rows]).sum())
    # the bucket's words, metadata and row ids; its CSR rows and entries
    moved = sum(nbytes(t) for t in tensors[:-3]) + (rows.numel() + 1) * 8
    moved += n_exc * (8 + exc_data.element_size())
    inside = 0
    if E is None:
        moved += rows.numel() * 2 * w
        last = 2 * cmp
    else:
        moved += E * w + (E + 1) * 8 + R * 4 * w
        last = math.ceil(math.log2(E + 1)) * cmp + 1
        if rank is not None:
            last, inside = 0, int(rank[rows].sum())
        elif R:
            last += R * RANK_ALL[0] * cmp
            inside = int(hits[rows].sum()) * RANK_ALL[1] * cmp
    n = valid_values(plan, rows)
    if call.scheme == "alp":
        dec = every + (unpack if call.bw else 0)
        flops = 2 * n
    else:
        lbw = call.args[3]
        dec = rd_every + (rd_unpack if call.bw else 0) + (2 if lbw else 0)
        flops = 0
    return moved, n * (dec + key + last) + inside, flops


# ---------------------------------------------------------------------------
# group (K18, K19) helpers and the references
# ---------------------------------------------------------------------------

def exact_totals(x: np.ndarray, g: np.ndarray, G: int) -> tuple:
    """The exact sums of G groups of the values ``x`` (group ids ``g``),
    computed apart from the port: ([the sum of each group's finite values
    times 2^B, a Python int], int64 [G, 3] NaN, +Inf and -Inf counts).  A
    finite value is +-m' 2^(e_eff - B); m' is cut into three 18-bit chunks,
    whose signed sums per (group, e_eff) stay below 2^53 and so are exact in
    ``np.bincount``'s float64, then joined as Python ints."""
    S, EB, MB = (64, 11, 52) if x.dtype == np.float64 else (32, 8, 23)
    b = x.view(f"u{x.itemsize}").astype(np.uint64)
    e = ((b >> np.uint64(MB)) & np.uint64((1 << EB) - 1)).astype(np.int64)
    m = b & np.uint64((1 << MB) - 1)
    neg = (b >> np.uint64(S - 1)) != 0
    special = e == (1 << EB) - 1
    sp = np.stack([np.bincount(g[special & c], minlength=G) for c in (
        m != 0, (m == 0) & ~neg, (m == 0) & neg)], axis=1)
    fin = ~special & ((m != 0) | (e != 0))         # nonzero and finite
    mp = np.where(e > 0, m | np.uint64(1 << MB), m)[fin].astype(np.int64)
    ee = np.maximum(e, 1)[fin]
    sign = np.where(neg[fin], -1.0, 1.0)
    present = np.flatnonzero(np.bincount(ee, minlength=1 << EB))
    slot = np.zeros(1 << EB, np.int64)
    slot[present] = np.arange(len(present))
    idx = g[fin] * len(present) + slot[ee]
    chunks = np.stack([np.bincount(idx, weights=sign * ((mp >> (18 * c))
                                                        & 0x3FFFF),
                                   minlength=G * len(present))
                       for c in range(3)], axis=1).reshape(G, -1, 3)
    totals = [0] * G
    for gi, ej in zip(*np.nonzero(chunks.any(axis=2))):
        c0, c1, c2 = (int(v) for v in chunks[gi, ej])
        totals[gi] += (c0 + (c1 << 18) + (c2 << 36)) << int(present[ej])
    return totals, sp


def rounded(total: int, sp, count: int, dtype, mean: bool) -> float:
    """A group's exact SUM (or MEAN) rounded once to a double, then to the
    column dtype: NaN for a NaN or +Inf with -Inf (and a MEAN of no value),
    the infinity, 0.0, or the exact rational over 2^B (times ``count``)."""
    nan, pinf, ninf = (int(v) for v in sp)
    if (mean and count == 0) or nan or (pinf and ninf):
        r = math.nan
    elif pinf or ninf:
        r = math.inf if pinf else -math.inf
    elif total == 0:
        r = 0.0
    else:
        scale = 1075 if np.dtype(dtype) == np.float64 else 150
        r = float(Fraction(total, (count if mean else 1) << scale))
    return float(np.dtype(dtype).type(r))


def group_reference(x, krow, G: int, every: bool, rng, g=None,
                    bounds=None) -> dict:
    """Reference answers of a grouping of the whole input ``x`` (``krow``
    its total-order keys in row order) by group ids ``g``, or into the
    contiguous groups of ``bounds``: counts and the least and largest
    values of every group (numpy over the rows ordered by group), and for
    every group (``every``) or up to GROUP_SAMPLES seeded ones of at most
    SAMPLE_VALUES values in all the exact SUM and MEAN (``exact_totals``,
    also returned as "exact") and ``math.fsum`` of the group's values."""
    if bounds is None:
        counts = np.bincount(g, minlength=G)
        small = np.uint8 if G <= 256 else np.uint16 if G <= 65536 else None
        order = np.argsort(g.astype(small) if small else g, kind="stable")
        bounds = np.concatenate([[0], np.cumsum(counts)])
        ks, xs = krow[order], x[order]
        del order
    else:
        counts = np.diff(bounds)
        ks, xs = krow, x
    live = np.flatnonzero(counts)
    ends = {}
    for name, ufunc in (("min", np.minimum), ("max", np.maximum)):
        vals = np.full(G, np.nan, x.dtype)
        vals[live] = values_of_keys(ufunc.reduceat(ks, bounds[live]),
                                    x.dtype)
        ends[name] = vals
    picked = np.arange(G)
    if not every:
        picked = rng.permutation(G)[:GROUP_SAMPLES]
        keep = np.cumsum(counts[picked]) <= SAMPLE_VALUES
        picked = np.sort(picked[keep | (np.arange(len(picked)) == 0)])
    parts = [xs[bounds[i]:bounds[i + 1]] for i in picked.tolist()]
    if every and g is not None:
        exact = exact_totals(x, g, G)
        totals, sp = exact
    else:
        sub = np.concatenate(parts) if parts else x[:0]
        exact = exact_totals(sub, np.repeat(np.arange(len(picked)),
                                            counts[picked]), len(picked))
        totals, sp = [None] * G, np.zeros((G, 3), np.int64)
        for j, i in enumerate(picked.tolist()):
            totals[i], sp[i] = exact[0][j], exact[1][j]
    checked = {}
    for j, i in enumerate(picked.tolist()):
        c = int(counts[i])
        checked[i] = (rounded(totals[i], sp[i], c, x.dtype, False),
                      rounded(totals[i], sp[i], c, x.dtype, True),
                      float(x.dtype.type(fsum_reference(parts[j])))
                      if c else 0.0)
    return {"count": counts, **ends, "checked": checked, "exact": exact}


def sliding_reference(x, krow, window: int, hop: int, rng) -> dict:
    """Reference answers of the sliding windows [i hop, i hop + window):
    counts and least and largest values from the hop-sized cells'
    (``np.minimum.reduceat``), and for seeded sampled windows of at most
    SAMPLE_VALUES values in all the exact SUM and MEAN (``exact_totals``)
    and ``math.fsum``."""
    n, k = len(x), window // hop
    ncells = -(-n // hop)
    nw = max(-(-max(n - window, 0) // hop) + 1, 1)
    cb = np.minimum(np.arange(ncells + 1) * hop, n)
    end = np.minimum(np.arange(nw) + k, ncells)
    cmin = np.minimum.reduceat(krow, cb[:-1])
    cmax = np.maximum.reduceat(krow, cb[:-1])
    kmin, kmax = cmin[:nw].copy(), cmax[:nw].copy()
    for j in range(1, k):
        at = np.minimum(np.arange(nw) + j, ncells - 1)
        kmin, kmax = np.minimum(kmin, cmin[at]), np.maximum(kmax, cmax[at])
    counts = cb[end] - cb[:nw]
    picked = np.sort(rng.permutation(nw)[:max(1, min(
        GROUP_SAMPLES, SAMPLE_VALUES // window))])
    parts = [x[i * hop:i * hop + window] for i in picked.tolist()]
    totals, sp = exact_totals(np.concatenate(parts), np.repeat(
        np.arange(len(picked)), [len(q) for q in parts]), len(picked))
    checked = {}
    for j, i in enumerate(picked.tolist()):
        c = len(parts[j])
        checked[i] = (rounded(totals[j], sp[j], c, x.dtype, False),
                      rounded(totals[j], sp[j], c, x.dtype, True),
                      float(x.dtype.type(fsum_reference(parts[j]))))
    return {"count": counts, "min": values_of_keys(kmin, x.dtype),
            "max": values_of_keys(kmax, x.dtype), "checked": checked}


def group_inputs(n: int, seed: list) -> dict:
    """The seeded group ids of the group phase for a column of n values: G
    -> random ids in [0, G) for each of GROUP_SIZES, and "ordered" ->
    ORDERED_RUNS runs in order of random lengths."""
    out = {G: np.random.default_rng(seed + [G]).integers(0, G, n)
           for G in GROUP_SIZES}
    rng = np.random.default_rng(seed + [0])
    cuts = np.sort(rng.choice(n - 1, ORDERED_RUNS - 1, replace=False) + 1)
    out["ordered"] = np.repeat(np.arange(ORDERED_RUNS),
                               np.diff(np.concatenate([[0], cuts, [n]])))
    return out


def group_reference_task(spec: tuple, every: bool, seed: list,
                         case) -> tuple:
    """One reference of the group phase, in a worker process: (``case``,
    its reference).  ``spec`` = (shared-memory name, length, dtype) holds
    the column's input, the groups are ``group_inputs``'; ``case`` is G for
    GROUP-BY over G random groups (at G = 16 every group is checked and its
    exact totals are returned too), "ordered", ("window", w) or
    "sliding"."""
    shm = shared_memory.SharedMemory(name=spec[0])
    try:
        x = np.ndarray((spec[1],), spec[2], buffer=shm.buf)
        n = len(x)
        rng = np.random.default_rng(seed + [2, sum(map(ord, repr(case)))])
        krow = np_keys(x)
        if case == "sliding":
            ref = sliding_reference(x, krow, *SLIDING, rng)
        elif case == "ordered":
            g = group_inputs(n, seed)["ordered"]
            bounds = np.concatenate([[0], np.flatnonzero(np.diff(g)) + 1,
                                     [n]])
            ref = group_reference(x, krow, ORDERED_RUNS, every, rng,
                                  bounds=bounds)
        elif isinstance(case, tuple):
            nw = -(-n // case[1])
            ref = group_reference(
                x, krow, nw, every, rng,
                bounds=np.minimum(np.arange(nw + 1) * case[1], n))
        else:
            ref = group_reference(x, krow, case, every or case <= 16, rng,
                                  g=group_inputs(n, seed)[case])
        if case != 16:
            ref.pop("exact", None)
        del x, krow
        return case, ref
    finally:
        shm.close()


def check_group_answer(label: str, got: dict, ref: dict, dtype) -> None:
    """A GROUP-BY or window answer against its reference, by bits (NaN by
    isnan): every count, least and largest value, and the checked groups'
    SUM (the exact one and ``math.fsum``) and MEAN."""
    G = len(ref["count"])
    if list(got) != ["sum", "count", "min", "max", "mean"]:
        raise RuntimeError(f"{label}: aggregates {list(got)}")
    for a in ("sum", "min", "max", "mean"):
        if got[a].dtype != np.dtype(dtype) or got[a].shape != (G,):
            raise RuntimeError(f"{label}: {a} {got[a].dtype} "
                               f"{got[a].shape}")
    if not np.array_equal(got["count"], ref["count"]) or \
            got["count"].dtype != np.int64:
        raise RuntimeError(f"{label}: counts differ from numpy")
    for a in ("min", "max"):
        if not same_quantile(got[a], ref[a], dtype) or np.any(
                (got[a] == 0) & (np.signbit(got[a]) != np.signbit(ref[a]))):
            raise RuntimeError(f"{label}: {a} differs from numpy")
    for g, (total, mean, fsum) in ref["checked"].items():
        s, mu = float(got["sum"][g]), float(got["mean"][g])
        if not (same_float(s, total) and same_float(mu, mean)
                and (fsum is None or same_float(s, fsum))):
            raise RuntimeError(f"{label}: group {g} sum {s!r} mean {mu!r}, "
                               f"exact {total!r} fsum {fsum!r} mean "
                               f"{mean!r}")


def distinct_reference(keys: np.ndarray, dtype) -> int:
    """COUNT(DISTINCT) from the sorted total-order keys: the distinct keys
    between key(-inf) and key(+inf), and one more for any NaN."""
    lo = int(np.searchsorted(keys, keys.dtype.type(key_of(-math.inf, dtype))))
    hi = int(np.searchsorted(keys, keys.dtype.type(key_of(math.inf, dtype)),
                             "right"))
    mid = keys[lo:hi]
    inner = 1 + int(np.count_nonzero(mid[1:] != mid[:-1])) if mid.size else 0
    return inner + int(lo > 0 or hi < len(keys))


def column_group_keys(plan, G: int, ordered: bool, seed: int):
    """int32 [n_vectors, 1024] group ids in column order, made on the plan's
    card from ``seed``: random ids in [0, G), or G runs in order of random
    lengths (the pad takes ids as well; the kernels skip it)."""
    import torch
    gen = torch.Generator(plan.device).manual_seed(seed)
    n = plan.n_vectors * VECTOR
    if not ordered:
        return torch.randint(0, G, (plan.n_vectors, VECTOR), generator=gen,
                             dtype=torch.int32, device=plan.device)
    cuts = torch.sort(torch.randint(1, plan.n_values, (G - 1,), generator=gen,
                                    device=plan.device)).values
    pos = torch.arange(n, device=plan.device).clamp(max=plan.n_values - 1)
    return torch.searchsorted(cuts, pos, right=True).to(torch.int32).view(
        plan.n_vectors, VECTOR)


def group_work(plan, call, bits, kind: str) -> tuple:
    """(bytes, integer operations, float operations) one K18 (``kind``
    "sums") or K19 ("groups") call needs on this run's data: its inputs
    read once (as ``key_work`` counts them, and K19's 4 bytes of group id a
    value), K18's rows and keys written once (K19's [G, W + 4] totals and
    [G, 2] keys are counted once by the caller), KEY_OPS's decode, key and
    two compares (a least and a largest key) a value, and the exact sum's
    SUM_OPS counted on the decoded ``bits``."""
    moved, int_ops, flops = key_work(plan, call, None)
    w = 8 if plan.f64 else 4
    rows = call.rows
    moved -= rows.numel() * 2 * w              # key_work's K16 output
    if kind == "sums":
        moved += rows.numel() * (((66 if plan.f64 else 9) + 3) * 8 + 2 * w)
    else:
        moved += valid_values(plan, rows) * 4
    digits = types.SimpleNamespace(
        kernel="exact_sum_f64" if plan.f64 else "exact_sum_f32", rows=rows,
        bw=0)
    return moved, int_ops + sum_ops(plan, digits, bits)[1], flops


# ---------------------------------------------------------------------------
# device compress (K9-K14) helpers
# ---------------------------------------------------------------------------

def dc_modules():
    from alp_tpu_torch import device_compress as dc
    from alp_tpu_torch.kernels import encode as kenc
    from alp_tpu_torch.kernels import ffor as kffor
    from alp_tpu_torch.kernels import score as kscore
    return dc, kenc, kffor, kscore


def dc_counts() -> dict:
    _, kenc, kffor, kscore = dc_modules()
    return {k: v for k, v in {**kscore.LAUNCHES, **kenc.LAUNCHES,
                              **kffor.LAUNCHES}.items() if k in DC_KERNELS}


def dc_reset() -> None:
    _, kenc, kffor, kscore = dc_modules()
    for module in (kenc, kffor, kscore):
        module.reset_launches()


def int_err(a, b) -> float:
    """Largest difference of two integer or boolean tensors (0.0 when
    their bits are equal)."""
    import torch
    if a.shape == b.shape and torch.equal(a, b):
        return 0.0
    if a.shape != b.shape:
        return float("inf")
    return float((a.double() - b.double()).abs().max())


def glue_left(bits, rbw: int):
    """K21's left input: the int32 left part above the low ``rbw`` bits of
    each decoded ALP_RD pattern (dictionary resolved, exceptions in)."""
    import torch
    S = 8 * bits.element_size()
    u = bits.to(torch.int64) if S == 64 else bits.to(torch.int64) & (
        (1 << 32) - 1)
    left = (u >> rbw) & ((1 << (S - rbw)) - 1) if rbw else u
    return (left if S == 64 else torch.where(
        left >= 1 << 31, left - (1 << 32), left)).to(torch.int32)


def dc_plain(name, args, kwargs):
    """The plain version's outputs of one K9-K14 wrapper call."""
    _, kenc, kffor, kscore = dc_modules()
    if name.startswith("alp_encode"):
        return getattr(kenc, DC_WRAPPERS[name][1])(*args, **kwargs)
    if name.startswith("score_pairs"):
        return getattr(kscore, DC_WRAPPERS[name][1])(*args, **kwargs)
    values, base, bw = args
    return (kffor.ffor_plain(values, base, bw, kwargs.get("exc"),
                             kwargs.get("fill"), kwargs.get("rows")),)


def dc_outputs(name, got, args, kwargs):
    """The outputs of one K9-K14 wrapper call, as ``dc_plain`` gives them
    (K10/K13: the call's own words of a shared buffer)."""
    _, _, kffor, _ = dc_modules()
    if not name.startswith("ffor_pack"):
        return got
    offsets = kwargs.get("offsets")
    lanes = VECTOR // (8 * args[0].element_size())
    return (got if offsets is None
            else got[kffor._word_index(offsets, args[2], lanes)],)


def record_dc_calls(run):
    """``run()`` with K9-K14's wrappers wrapped: each call launches its
    kernel, then the plain version runs on the same inputs and the two are
    compared.  Returns (run's result, [(name, args, kwargs, max_abs_err,
    launches, outputs)]): ``launches`` the (C entry, device, arguments)
    that the wrapper passed to ``_launch`` after its checks, for timing
    the kernel alone (the wrappers' range checks read their indices back
    to the host), ``outputs`` kept so those arguments' buffers live."""
    import torch
    dc, kenc, kffor, kscore = dc_modules()
    calls, launched = [], []
    holders = {"dc": dc, "kscore": kscore}
    real = {name: getattr(holders[where], name)
            for name, (where, _) in DC_WRAPPERS.items()}
    real_launch = kenc._launch

    def capture(entry, device, *args):
        launched.append((entry, device, args))
        return real_launch(entry, device, *args)

    def wrapped(name):
        fn = real[name]

        def call(*args, **kwargs):
            first = len(launched)
            got = fn(*args, **kwargs)
            mine = [t.clone() for t in dc_outputs(name, got, args, kwargs)]
            want = dc_plain(name, args, kwargs)
            torch.cuda.synchronize()
            err = max(int_err(a, b) for a, b in zip(mine, want))
            if len(mine) != len(want):
                err = float("inf")
            calls.append((name, args, kwargs, err, launched[first:], got))
            return got
        return call

    for name, (where, _) in DC_WRAPPERS.items():
        setattr(holders[where], name, wrapped(name))
    for module in (kenc, kffor, kscore):
        module._launch = capture
    try:
        result = run()
    finally:
        for name, (where, _) in DC_WRAPPERS.items():
            setattr(holders[where], name, real[name])
        for module in (kenc, kffor, kscore):
            module._launch = real_launch
    return result, calls


def dc_work(name, args, kwargs) -> tuple:
    """(bytes, FP64 operations, FP32 operations, integer operations) one
    K9-K14 call needs on this run's inputs: every input read once, every
    output written once, DC_OPS a value or trial (K11/K14: only the pairs
    a segment scores)."""
    fp64, fp32, it, extra = DC_OPS[name]
    w = args[0].element_size()             # 8 for f64 / int64, 4 for f32
    if name.startswith("alp_encode"):
        n = args[0].shape[0]
        stats = kwargs.get("stats", True)
        vals = n * VECTOR
        moved = (vals * (w + w + 1) + n * 8
                 + (n * (8 + 2 * w) if stats else 0))
        return (moved, vals * fp64, vals * fp32,
                vals * (it + (extra if stats else 0)))
    if name.startswith("score_pairs"):
        samples, ef = args[:2]
        k = args[2] if len(args) > 2 else kwargs.get("k_count")
        n, cand = samples.shape[0], ef.shape[1]
        tasks = n * cand if k is None else int(k.clamp(max=cand).sum())
        moved = (nbytes(samples) + nbytes(ef) + n * cand * 8
                 + (nbytes(k) if k is not None else 0))
        return (moved, tasks * 32 * fp64, tasks * 32 * fp32,
                tasks * (32 * it + extra))
    values, base, bw = args
    rows, exc = kwargs.get("rows"), kwargs.get("exc") is not None
    m = values.shape[0] if rows is None else rows.shape[0]
    per_row = (w + w * exc + 8 * (rows is not None)
               + 8 * (kwargs.get("offsets") is not None))
    moved = m * VECTOR * (w + exc) + m * per_row + m * VECTOR * bw // 8
    return moved, 0, 0, m * VECTOR * it


# ---------------------------------------------------------------------------

def bench_rows(plans, columns, dev, errors, launches, int32_per_s,
               fp64_per_s, fp32_per_s) -> list:
    """The timing rows of K20-K23 on the 256 MiB columns: CUDA-event ms of
    the kernel over every eligible bucket of a column, its plain
    version's, its bound (bytes each input read once and each output
    written once at 3.35 TB/s; K20 also VSUM_OPS at the issue rates), and a
    ``copy_`` of the same number of bytes as the yardstick."""
    import torch
    from alp_tpu_torch.columns import BENCH_PROFILES
    from alp_tpu_torch.kernels import falp
    from alp_tpu_torch.kernels import ffor as kffor
    from alp_tpu_torch.kernels import group as kgroup
    from alp_tpu_torch.ops.fastlanes import unffor_unpack

    def alp(plan):
        return [b for b in plan.buckets if b.scheme == 2]

    def meta(b):
        return sum(nbytes(t) for t in b.args[1:])

    def k20(plan):
        bs = alp(plan)
        n_vals = sum(b.n_vectors for b in bs) * VECTOR
        unpacked = sum(b.n_vectors for b in bs if b.bw) * VECTOR
        ops = (n_vals * VSUM_OPS["every"] + unpacked * VSUM_OPS["unpack"],
               n_vals * VSUM_OPS["fp64"], n_vals * VSUM_OPS["fp32"])
        moved = sum(nbytes(b.args[0]) + meta(b) + b.n_vectors * 64
                    for b in bs)
        return (lambda: [falp.variant_sum_f64(b.args[0], b.bw, *b.args[1:])
                         for b in bs],
                lambda: [falp.variant_sum_plain(b.args[0], b.bw, *b.args[1:])
                         for b in bs], moved, ops)

    def k21(plan):
        scratch, _ = plan.decode_rd()
        rd = [b for b in plan.buckets if b.scheme != 2]
        k = "rd_glue_f64" if plan.f64 else "rd_glue_f32"
        calls = [(b, glue_left(scratch[r], b.bw))
                 for b, r in zip(rd, plan._rd_layout[0])]
        moved = sum(nbytes(b.args[0]) + nbytes(left) + nbytes(scratch[r])
                    for (b, left), r in zip(calls, plan._rd_layout[0]))
        return (lambda: [getattr(falp, k)(b.args[0], b.bw, left)
                         for b, left in calls],
                lambda: [falp.rd_glue_plain(b.args[0], b.bw, left)
                         for b, left in calls], moved, (0, 0, 0))

    def k22(plan):
        bs = alp(plan)
        moved = sum(nbytes(b.args[0]) + nbytes(b.args[1])
                    + b.n_vectors * VECTOR * b.args[0].element_size()
                    for b in bs)
        return (lambda: [kffor.unffor(b.args[0], b.bw, b.args[1])
                         for b in bs],
                lambda: [unffor_unpack(b.args[0], b.args[1], b.bw)
                         for b in bs], moved, (0, 0, 0))

    def k23(plan):
        bits = plan.run().view(torch.int64)
        moved = nbytes(bits) + plan.n_vectors * 16
        return (lambda: kgroup.key_extremes_bits_f64(bits),
                lambda: kgroup.key_extremes_bits_plain(bits), moved, (0, 0, 0))

    f64_cols = [*BENCH_PROFILES, "f64_alp_rd"]
    timed = {"variant_sum_f64": (k20, list(BENCH_PROFILES)),
             "rd_glue_f64": (k21, ["f64_alp_rd"]),
             "rd_glue_f32": (k21, ["f32_alp_rd"]),
             "unffor": (k22, [*BENCH_PROFILES, "f32_alp"]),
             "key_extremes_bits": (k23, f64_cols)}
    out = []
    for k, (work, names) in timed.items():
        ms, plain_ms, bound_ms, copy_ms, b_bytes_l, b_ops_l = (
            [] for _ in range(6))
        for name in names:
            plan = plans[name]
            run, plain, moved, (int_ops, fp64_ops, fp32_ops) = work(plan)
            t_k = cuda_ms(run, 20)
            t_p = cuda_ms(plain, 3)
            src = torch.empty(moved, dtype=torch.uint8, device=dev)
            dst = torch.empty_like(src)
            t_c = cuda_ms(lambda: dst.copy_(src), 20)
            del src, dst
            b_bytes = moved / HBM_BYTES_PER_S * 1e3
            b_ops = max(int_ops / int32_per_s, fp64_ops / fp64_per_s,
                        fp32_ops / fp32_per_s) * 1e3
            ms.append(t_k)
            plain_ms.append(t_p)
            bound_ms.append(max(b_bytes, b_ops))
            copy_ms.append(t_c)
            b_bytes_l.append(b_bytes)
            b_ops_l.append(b_ops)
            print(f"  {k} on {name}: {moved} bytes, {int_ops} int ops, "
                  f"{fp64_ops} FP64 ops, {fp32_ops} FP32 ops, kernel "
                  f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                  f"{max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f} ms, "
                  f"operations {b_ops:.4f} ms), share "
                  f"{max(b_bytes, b_ops) / t_k:.1%}, copy_ {t_c:.4f} ms",
                  flush=True)
        src, site = BENCH_KERNELS[k]
        out.append({
            "name": k, "route": "cuda", "source": src, "replaces": site,
            "also_replaces": [], "launches": launches[k],
            "max_abs_err": errors[k], "ms": float(np.mean(ms)),
            "plain_ms": float(np.mean(plain_ms)),
            "bound_ms": float(np.mean(bound_ms)),
            "bound_by": ("bytes" if sum(b_bytes_l) >= sum(b_ops_l)
                         else "operations"),
            "library_ms": None, "yardstick_ms": float(np.mean(copy_ms)),
            "yardstick": "Tensor.copy_ of as many bytes as the kernel "
                         "moves (not the same function: no PyTorch call "
                         "reads the FastLanes words or cuts doubles as the "
                         "reference does)",
            "timed_on": names})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_all = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import alp_tpu_torch
        from alp_tpu_torch import engine, native
        from alp_tpu_torch.columns import (BENCH_PROFILES, route_columns,
                                           tile_column)
        from alp_tpu_torch import bench as pbench
        from alp_tpu_torch import bench_speed
        from alp_tpu_torch import device_compress as dc
        from alp_tpu_torch.kernels import _build, decode, falp
        from alp_tpu_torch.kernels import encode as kenc
        from alp_tpu_torch.kernels import exact_sum as kes
        from alp_tpu_torch.kernels import ffor as kffor
        from alp_tpu_torch.kernels import group as kgroup
        from alp_tpu_torch.kernels import keys as kkeys
        from alp_tpu_torch.kernels import score as kscore
        from alp_tpu_torch.ops.fastlanes import unffor_unpack
        from alp_tpu_torch.ops.keys import bias, biased_keys
    except ImportError as e:
        print(f"chip_smoke: alp_tpu_torch is not importable: {e}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # 1. env
    t0 = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_sm_mhz = float(nvidia_smi("clocks.max.sm"))
    int32_per_s = sms * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    fp64_per_s = sms * FP64_LANES_PER_SM * max_sm_mhz * 1e6
    fp32_per_s = sms * FP32_LANES_PER_SM * max_sm_mhz * 1e6
    phase("env", t0, f"device={kind!r} nvidia-smi={smi!r} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"SMs={sms} max SM clock={max_sm_mhz} MHz "
          f"INT32 issue rate={int32_per_s:.4g}/s "
          f"FP64 issue rate={fp64_per_s:.4g}/s "
          f"FP32 issue rate={fp32_per_s:.4g}/s")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    _build.lib()
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    t1 = time.perf_counter()
    _, gxx_s = native.build()
    native.lib()
    phase("build", t0, f"nvcc={built['seconds']:.3f}s "
          f"({'cold' if built['seconds'] else 'cached'}) "
          f"g++={gxx_s:.3f}s "
          f"({'cold' if gxx_s else 'cached'}) "
          f"load={time.perf_counter() - t1 - gxx_s:.3f}s")

    # 3. compress
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    columns = {}
    tile_to = dict(TILE_TO, **{name: BENCH_VECTORS for name in BENCH_PROFILES})
    for name, x in route_columns(rng, SOURCE_VECTORS).items():
        target = tile_to.get(name)
        tc = time.perf_counter()
        col = alp_tpu_torch.compress(x)
        blob = col.to_bytes()
        col = alp_tpu_torch.CompressedColumn.from_bytes(blob)
        if col.to_bytes() != blob:
            raise RuntimeError(f"{name}: ALPT bytes do not re-serialise")
        schemes = sorted({"ALP" if s == 2 else "ALP_RD"
                          for s in col.rg_scheme.tolist()})
        alp = col.rg_scheme[np.arange(col.n_vectors) // ROWGROUP_VECTORS] == 2
        bws = sorted(set(col.bit_width[alp].tolist()))
        note = ""
        if name == "f64_alp_bw53_64" and not any(b >= 53 for b in bws):
            note = (" NOTE: the planner gave this column no ALP vector "
                    "of bit width 53-64")
        print(f"  {name}: n={len(x)} rowgroups={col.n_rowgroups} "
              f"schemes={schemes} alp_bit_widths={bws} "
              f"exceptions={int(col.exc_count.sum())} "
              f"bits/value={col.bits_per_value():.3f} "
              f"compress={time.perf_counter() - tc:.3f}s{note}", flush=True)
        expected = x
        if target:
            col = tile_column(col, target)
            reps = -(-target * VECTOR // len(x))
            expected = np.tile(x, reps)[:target * VECTOR]
        columns[name] = (col, expected)
    phase("compress", t0, f"{len(columns)} columns")

    # 4. decode: the main path, through the public entry point
    t0 = time.perf_counter()
    expected_dev = {
        name: torch.from_numpy(exp.view(f"i{exp.dtype.itemsize}")).to(dev)
        for name, (_, exp) in columns.items()}
    torch.cuda.synchronize()
    falp.reset_launches()
    td = time.perf_counter()
    for name, (col, _) in columns.items():
        before = dict(falp.LAUNCHES)
        tw = time.perf_counter()
        out = alp_tpu_torch.decompress(col)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
        if out.shape != (col.n_values,) or out.device.type != "cuda":
            raise RuntimeError(f"{name}: decoded shape {tuple(out.shape)} "
                               f"on {out.device}")
        if not torch.equal(bits_view(out), expected_dev[name]):
            bad = int((bits_view(out) != expected_dev[name]).sum())
            raise RuntimeError(f"{name}: {bad} decoded values differ "
                               f"from the input bits")
        moved = {k: v - before[k] for k, v in falp.LAUNCHES.items()
                 if v != before[k]}
        if not moved:
            raise RuntimeError(f"{name}: no kernel launched")
        print(f"  {name}: {col.n_values} values bit-exact, "
              f"launches={moved}, decompress wall {wall:.4f} s "
              f"(host plan + copies + kernels)", flush=True)
    main_launches = {k: falp.LAUNCHES[k] for k in KERNELS}
    decode_s = time.perf_counter() - td
    for k, v in main_launches.items():
        if v == 0:
            raise RuntimeError(f"kernel {k} was not launched on the main path")
    del expected_dev
    phase("decode", t0, f"main path {decode_s:.3f}s launches={main_launches}")

    # 5. bench: the port's headline on the five 256 MiB profiles and its
    # kernel rows, the path of K20-K23
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    for module in (falp, kffor, kgroup):
        module.reset_launches()
    tb = time.perf_counter()
    results = {name: pbench.bench_column(columns[name][0], dev)
               for name in BENCH_PROFILES}
    pbench.report(results, out=sys.stdout)
    print(json.dumps(pbench.headline(results)), flush=True)
    bench_errors, checked, check_s = {}, set(), [0.0]

    def bench_check(name, step, step_args, plain):
        """A K20-K23 row's output on the row's own inputs against the
        plain version, by bits; its launches are not counted."""
        if name not in BENCH_ROWS:
            return
        tc = time.perf_counter()
        saved = [dict(m.LAUNCHES) for m in (falp, kffor, kgroup, kes, kkeys)]
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        got = step.result(zero, *step_args)
        if plain is not None:
            pairs = [(got, plain.result(zero, *step_args))]
        else:                   # the sum step: K20 on its ALP buckets
            plan, = step_args
            pairs = [(part, falp.variant_sum_plain(b.args[0], b.bw,
                                                   *b.args[1:]))
                     for b, part in zip(plan.buckets, got) if part.dim() == 2]
        for m, counts in zip((falp, kffor, kgroup, kes, kkeys), saved):
            m.LAUNCHES.update(counts)
        if not pairs:
            raise RuntimeError(f"bench row {name}: no K20 output to check")
        err = max(int_err(bits_view(a), bits_view(b)) for a, b in pairs)
        k = BENCH_ROWS[name]
        bench_errors[k] = max(bench_errors.get(k, 0.0), err)
        if err != 0.0:
            raise RuntimeError(f"bench row {name}: {k} differs from its "
                               f"plain version (max err {err})")
        print(f"  {name}: {k} == plain on the row's inputs "
              f"({sum(a.numel() for a, _ in pairs)} outputs)", flush=True)
        checked.add(name)
        check_s[0] += time.perf_counter() - tc

    bench_speed.rows(dev, args.seed, check=bench_check)
    bench_s = time.perf_counter() - tb - check_s[0]
    if checked != set(BENCH_ROWS):
        raise RuntimeError(f"bench rows left unchecked: "
                           f"{sorted(set(BENCH_ROWS) - checked)}")
    bench_launches = {k: {**falp.LAUNCHES, **kffor.LAUNCHES,
                          **kgroup.LAUNCHES}[k] for k in BENCH_KERNELS}
    for k, v in bench_launches.items():
        if v == 0:
            raise RuntimeError(f"kernel {k} was not launched on the bench "
                               f"path")
    phase("bench", t0, f"bench path {bench_s:.3f}s (checks "
          f"{check_s[0]:.3f}s apart) launches={bench_launches}")

    # 6. sum: the SUM path, through the public entry points
    t0 = time.perf_counter()
    sums = {name: fsum_reference(exp) for name, (_, exp) in columns.items()}
    ref_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    kes.reset_launches()
    ts = time.perf_counter()
    for name, (col, _) in columns.items():
        before = dict(kes.LAUNCHES)
        tw = time.perf_counter()
        first = alp_tpu_torch.query_sum(col)
        first_s = time.perf_counter() - tw
        tw = time.perf_counter()
        again = alp_tpu_torch.query_sum(col)
        again_s = time.perf_counter() - tw
        for got in (first, again):
            if not same_float(got, sums[name]):
                raise RuntimeError(f"{name}: query_sum {got!r} != math.fsum "
                                   f"{sums[name]!r}")
        moved = {k: v - before[k] for k, v in kes.LAUNCHES.items()
                 if v != before[k]}
        if not moved:
            raise RuntimeError(f"{name}: no SUM kernel launched")
        print(f"  {name}: query_sum {first.hex()} == math.fsum, launches "
              f"(two calls)={moved}, first call {first_s:.4f} s "
              f"(plan build + copies + kernels), cached plan "
              f"{again_s * 1e3:.3f} ms", flush=True)
    sum_launches = dict(kes.LAUNCHES)
    sum_s = time.perf_counter() - ts
    for k, v in sum_launches.items():
        if v == 0:
            raise RuntimeError(f"kernel {k} was not launched on the SUM path")
    tm = time.perf_counter()
    for name, (_, exp) in columns.items():
        x = exp[:MEAN_VECTORS * VECTOR]
        small = alp_tpu_torch.compress(x)
        got = alp_tpu_torch.query_mean(small)
        want = exact_mean_reference(x)
        if not same_float(got, want):
            raise RuntimeError(f"{name}: query_mean {got!r} != exact mean "
                               f"{want!r} over {len(x)} values")
    print(f"  query_mean == exact rational mean on {len(columns)} columns "
          f"of {MEAN_VECTORS * VECTOR} values "
          f"({time.perf_counter() - tm:.3f} s)")
    phase("sum", t0, f"math.fsum references {ref_s:.3f}s, SUM path "
          f"{sum_s:.3f}s launches={sum_launches}")

    # 6. query: the predicate and order queries, through the public entries
    t0 = time.perf_counter()
    sorted_keys = {name: np.sort(np_keys(exp))
                   for name, (_, exp) in columns.items()}
    refs = {name: query_references(exp, sorted_keys[name], col.n_vectors,
                                   name not in tile_to)
            for name, (col, exp) in columns.items()}
    ref_s = time.perf_counter() - t0
    for col, _ in columns.values():
        col._plans.clear()            # the first query builds the plan again
    torch.cuda.synchronize()
    kkeys.reset_launches()
    kes.reset_launches()
    tq = time.perf_counter()
    for name, (col, _) in columns.items():
        before = {**kkeys.LAUNCHES, **kes.LAUNCHES}
        walls = []
        for label, call, want, how in refs[name]:
            tw = time.perf_counter()
            got = call(alp_tpu_torch, col)
            first_s = time.perf_counter() - tw
            tw = time.perf_counter()
            again = call(alp_tpu_torch, col)
            again_s = time.perf_counter() - tw
            for answer in (got, again):
                if not same_answer(answer, want, how):
                    raise RuntimeError(f"{name}: {label} gave {answer!r}, "
                                       f"numpy {want!r}")
            walls.append(f"{label} {first_s * 1e3:.3f}/{again_s * 1e3:.3f}")
        moved = {k: v - before[k] for k, v in {**kkeys.LAUNCHES,
                                                **kes.LAUNCHES}.items()
                 if v != before[k]}
        print(f"  {name}: {len(refs[name])} queries == numpy on "
              f"{col.n_values} values, launches (two calls each)={moved}; "
              f"walls ms, first call/kept plan: {'; '.join(walls)}",
              flush=True)
    query_launches = {k: kkeys.LAUNCHES[k] for k in KEY_KERNELS}
    filtered_launches = dict(kes.LAUNCHES)
    query_s = time.perf_counter() - tq
    for k, v in {**query_launches, **filtered_launches}.items():
        if v == 0:
            raise RuntimeError(f"kernel {k} was not launched on the query "
                               f"path")
    del refs
    phase("query", t0, f"numpy references {ref_s:.3f}s, query path "
          f"{query_s:.3f}s launches={query_launches} filtered SUM "
          f"launches={filtered_launches}")

    # 7. quantile: QUANTILE / MEDIAN, through the public entry points
    t0 = time.perf_counter()
    qrefs = {}
    for name, (_, exp) in columns.items():
        xs = values_of_keys(sorted_keys[name], exp.dtype)
        qrefs[name] = {m: np.quantile(xs, QUANTILE_QS, method=m)
                       for m in METHODS}
        qrefs[name]["median"] = np.quantile(xs, 0.5)
        del xs
    ref_s = time.perf_counter() - t0
    for col, _ in columns.values():
        col._plans.clear()            # the first call builds the plan again
    torch.cuda.synchronize()
    kkeys.reset_launches()
    tq = time.perf_counter()
    linear_passes = {}
    for name, (col, exp) in columns.items():
        before = dict(kkeys.LAUNCHES)
        walls, passes = [], []
        for m in (*METHODS, "median"):
            for attempt in range(2):
                tw = time.perf_counter()
                got = (alp_tpu_torch.query_median(col) if m == "median" else
                       alp_tpu_torch.query_quantile(col, QUANTILE_QS, m))
                wall = time.perf_counter() - tw
                if not same_quantile(got, qrefs[name][m], exp.dtype):
                    raise RuntimeError(f"{name}: quantile {m} gave {got!r}, "
                                       f"numpy {qrefs[name][m]!r}")
                walls.append(wall)
                passes.append(engine.LAST_RANK_PASSES)
        moved = {k: v - before[k] for k, v in kkeys.LAUNCHES.items()
                 if v != before[k]}
        print(f"  {name}: 5 methods x {len(QUANTILE_QS)} quantiles and the "
              f"median == np.quantile on {col.n_values} values, launches "
              f"(two calls each)={moved}; walls ms, first call/kept plan: "
              + "; ".join(f"{m} {walls[2 * i] * 1e3:.3f}/"
                          f"{walls[2 * i + 1] * 1e3:.3f}"
                          for i, m in enumerate((*METHODS, "median")))
              + f"; passes a call {passes[::2]}", flush=True)
        linear_passes[name] = passes[0]
    quantile_launches = dict(kkeys.LAUNCHES)
    quantile_s = time.perf_counter() - tq
    for k in ("rank_pass", "key_extremes"):
        if quantile_launches[k] == 0:
            raise RuntimeError(f"kernel {k} was not launched on the quantile "
                               f"path")
    # the same linear QUANTILE with every probe uniform in key space (no
    # value-space or interpolated probes): what those probes save
    real_budget = engine._probe_budget
    engine._probe_budget = lambda n: ((kkeys.MAX_THRESHOLDS - 2) // n,) * 2
    try:
        for name, (col, exp) in columns.items():
            got = alp_tpu_torch.query_quantile(col, QUANTILE_QS, "linear")
            if not same_quantile(got, qrefs[name]["linear"], exp.dtype):
                raise RuntimeError(f"{name}: quantile with key-space probes "
                                   f"alone gave {got!r}")
            print(f"  {name}: linear passes {linear_passes[name]}, with "
                  f"key-space probes alone {engine.LAST_RANK_PASSES}",
                  flush=True)
    finally:
        engine._probe_budget = real_budget
    del qrefs
    phase("quantile", t0, f"numpy references {ref_s:.3f}s, quantile path "
          f"{quantile_s:.3f}s launches={quantile_launches}")

    # 8. group: GROUP-BY, windows, DISTINCT, through the public entries
    t0 = time.perf_counter()
    seeds = {name: [args.seed, i] for i, name in enumerate(columns)}
    # the references are independent: one process a (column, query), all
    # at once on the host's cores, the columns in shared memory
    shms = {name: shared_memory.SharedMemory(create=True, size=exp.nbytes)
            for name, (_, exp) in columns.items()}
    try:
        specs = {}
        for name, (_, exp) in columns.items():
            np.ndarray(exp.shape, exp.dtype, buffer=shms[name].buf)[:] = exp
            specs[name] = (shms[name].name, len(exp), exp.dtype.str)
        cases = [16, *(G for G in GROUP_SIZES if G not in (1, 16)),
                 "ordered", *(("window", w) for w in TUMBLING), "sliding"]
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=os.cpu_count() or 1,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            jobs = [(name, pool.submit(group_reference_task, specs[name],
                                       name not in tile_to, seeds[name],
                                       case))
                    for case in cases for name in sorted(
                        columns, key=lambda c: -columns[c][1].nbytes)]
            grefs = {name: {} for name in columns}
            for name, job in jobs:
                case, ref = job.result()
                grefs[name][case] = ref
    finally:
        for shm in shms.values():
            shm.close()
            shm.unlink()
    for name, (_, exp) in columns.items():
        totals, sp = grefs[name][16].pop("exact")
        total, sp = sum(totals), sp.sum(0)
        keys = sorted_keys[name]
        grefs[name][1] = {
            "count": np.array([len(exp)]),
            "min": values_of_keys(keys[:1], exp.dtype),
            "max": values_of_keys(keys[-1:], exp.dtype),
            "checked": {0: (
                rounded(total, sp, len(exp), exp.dtype, False),
                rounded(total, sp, len(exp), exp.dtype, True),
                float(exp.dtype.type(sums[name])))}}
    gcases = {}
    for name, (col, exp) in columns.items():
        inputs = group_inputs(len(exp), seeds[name])
        cases = [(f"groupby[G={G}]", inputs[G], G, grefs[name][G])
                 for G in GROUP_SIZES]
        cases.append((f"groupby[{ORDERED_RUNS} runs in order]",
                      inputs["ordered"], ORDERED_RUNS, grefs[name]["ordered"]))
        cases += [(f"window[{window}]", window, None,
                   grefs[name][("window", window)]) for window in TUMBLING]
        window, hop = SLIDING
        cases.append((f"window[{window}, hop {hop}]", window, hop,
                      grefs[name]["sliding"]))
        kvals = np.random.default_rng(seeds[name] + [1]).choice(
            [1.5, -3.0, 0.0, -0.0, 10.25, np.nan],
            min(len(exp), 4 * ROWGROUP_VECTORS * VECTOR))
        cases.append(("groupby_keys", kvals, None, None))
        cases.append(("distinct", None, None, distinct_reference(
            sorted_keys[name], exp.dtype)))
        gcases[name] = cases
    del grefs
    del sorted_keys
    ref_s = time.perf_counter() - t0
    for col, _ in columns.values():
        col._plans.clear()            # the first query builds the plan again
    torch.cuda.synchronize()
    kgroup.reset_launches()
    # the exact integer totals that each call rounds, as it hands them on,
    # and the seconds of that host finish
    raw_totals = []
    real_finish = engine._finish_groups

    def keep_totals(gr, aggs, dtype):
        tf = time.perf_counter()
        out = real_finish(gr, aggs, dtype)
        raw_totals.append((gr, time.perf_counter() - tf))
        return out

    engine._finish_groups = keep_totals
    tq = time.perf_counter()
    for name, (col, exp) in columns.items():
        before = dict(kgroup.LAUNCHES)
        col_total = None
        walls = []
        for label, a, b, ref in gcases[name]:
            if label == "groupby_keys":
                m = len(a)
                kcol = alp_tpu_torch.compress(a)
                vcol = alp_tpu_torch.compress(exp[:m])
                keys, uniques = alp_tpu_torch.groupby_keys(kcol)
                nan = np.isnan(a)
                if not (np.array_equal(uniques[keys][~nan], a[~nan])
                        and np.isnan(uniques[keys][nan]).all()):
                    raise RuntimeError(f"{name}: groupby_keys")
                got = alp_tpu_torch.query_groupby(vcol, keys, len(uniques))
                check_group_answer(f"{name}: groupby by groupby_keys", got,
                                   group_reference(exp[:m], np_keys(exp[:m]),
                                                   len(uniques), True, None,
                                                   g=keys), exp.dtype)
                continue
            if label == "distinct":
                call = alp_tpu_torch.query_distinct
            elif label.startswith("window"):
                call = functools.partial(alp_tpu_torch.query_window,
                                         window=a, hop=b)
            else:
                call = functools.partial(alp_tpu_torch.query_groupby,
                                         keys=a, num_groups=b)
            tw = time.perf_counter()
            got = call(col)
            first_s = time.perf_counter() - tw
            tw = time.perf_counter()
            again = call(col)
            again_s = time.perf_counter() - tw
            finish = (f" (finish {raw_totals[-1][1] * 1e3:.3f})"
                      if label != "distinct" else "")
            walls.append(f"{label} {first_s * 1e3:.3f}/{again_s * 1e3:.3f}"
                         f"{finish}")
            for answer in (got, again):
                if label == "distinct":
                    if answer != ref:
                        raise RuntimeError(f"{name}: distinct {answer} != "
                                           f"numpy {ref}")
                else:
                    check_group_answer(f"{name}: {label}", answer, ref,
                                       exp.dtype)
            if label == "distinct" or b == SLIDING[1]:
                continue
            if col_total is None:       # after the first call built the plan
                col_total = engine.join_totals(engine.exact_sum_totals(
                    col.plan(dev)).tolist(), exp.dtype)
            raw = raw_totals[-1][0]
            if (sum(raw.totals.values()), *raw.sp.sum(0).tolist()) != \
                    col_total[:4] or int(raw.ct.sum()) != len(exp):
                raise RuntimeError(f"{name}: {label}'s integer totals do not "
                                   f"join to the column's exact total")
        moved = {k: v - before[k] for k, v in kgroup.LAUNCHES.items()
                 if v != before[k]}
        print(f"  {name}: {len(gcases[name])} grouped queries == numpy on "
              f"{col.n_values} values, integer totals joined == the "
              f"column's, launches={moved}; walls ms, first call/kept "
              f"plan (the kept call's host finish): {'; '.join(walls)}",
              flush=True)
    group_launches = {k: kgroup.LAUNCHES[k] for k in GROUP_KERNELS}
    group_s = time.perf_counter() - tq
    engine._finish_groups = real_finish
    for k, v in group_launches.items():
        if v == 0:
            raise RuntimeError(f"kernel {k} was not launched on the group "
                               f"path")
    del gcases
    phase("group", t0, f"numpy references {ref_s:.3f}s, group path "
          f"{group_s:.3f}s launches={group_launches}")

    # 8. dcompress: the device compress path, through the public entry
    t0 = time.perf_counter()
    host_blobs = {}
    torch.cuda.synchronize()
    dc_reset()
    dc.reset_to_host()
    tp = time.perf_counter()
    for name in columns:
        x = columns[name][1]
        th = time.perf_counter()
        want = alp_tpu_torch.compress(x)
        host_s = time.perf_counter() - th
        blob = want.to_bytes()
        host_blobs[name] = blob
        before, copied = dc_counts(), dc.TO_HOST["bytes"]
        torch.cuda.synchronize()
        tw = time.perf_counter()
        got = alp_tpu_torch.compress_device(x)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - tw
        if got.to_bytes() != blob:
            raise RuntimeError(f"{name}: compress_device blob differs from "
                               f"host compress")
        moved = {k: v - before[k] for k, v in dc_counts().items()}
        copied = dc.TO_HOST["bytes"] - copied
        decoded = alp_tpu_torch.decompress(want)
        torch.cuda.synchronize()
        tw = time.perf_counter()
        again = alp_tpu_torch.compress_device(values=decoded,
                                              n_values=want.n_values)
        torch.cuda.synchronize()
        trip_s = time.perf_counter() - tw
        if again.to_bytes() != blob:
            raise RuntimeError(f"{name}: compress_device(values=decompress"
                               f"(col)) blob differs from host compress")
        del decoded
        print(f"  {name}: {want.n_values} values, blob {len(blob)} bytes "
              f"== host compress; device compress wall {dev_s:.4f} s "
              f"(host compress {host_s:.4f} s), launches={moved}, "
              f"{copied} bytes to the host; round trip from decompress "
              f"{trip_s:.4f} s, same bytes", flush=True)
    dc_launches = dc_counts()
    dc_s = time.perf_counter() - tp
    for k, v in dc_launches.items():
        if v == 0:
            raise RuntimeError(f"kernel {k} was not launched on the device "
                               f"compress path")
    phase("dcompress", t0, f"device compress path {dc_s:.3f}s "
          f"launches={dc_launches} (two compress_device calls a column)")

    # 9. kernels vs plain versions, on the card, same plans
    t0 = time.perf_counter()
    errors = {k: 0.0 for k in (*KERNELS, *SUM_KERNELS, *DC_KERNELS,
                               *KEY_KERNELS, *RANK_KERNELS, *GROUP_KERNELS,
                               *BENCH_KERNELS)}
    errors.update(bench_errors)             # the bench rows' own inputs
    plans = {}
    for name, (col, _) in columns.items():
        plan = decode.build_plan(col, dev)
        plans[name] = plan
        vdt = torch.float64 if plan.f64 else torch.float32
        for bucket in plan.buckets:
            a = torch.zeros((col.n_vectors, VECTOR), dtype=vdt, device=dev)
            b = torch.zeros_like(a)
            plan.launch(bucket, a)
            run_plain(plan, bucket, b)
            torch.cuda.synchronize()
            err = max_abs_err(a, b)
            k = kernel_of(plan, bucket)
            errors[k] = max(errors[k], err)
            if err != 0.0 or not torch.equal(bits_view(a), bits_view(b)):
                raise RuntimeError(
                    f"{name}: {k} bucket bw={bucket.bw} lbw={bucket.lbw} "
                    f"differs from its plain version (max abs err {err})")
    for name, (col, _) in columns.items():
        plan = col.plan(dev)
        for call in engine.sum_calls(plan):
            got = call.launch(kes.totals(plan.bits_dtype, dev))
            want = call.plain()
            err = float((got - want).abs().max())
            errors[call.kernel] = max(errors[call.kernel], err)
            if err != 0.0 or not torch.equal(got, want):
                raise RuntimeError(f"{name}: {call.kernel} totals "
                                   f"{got.tolist()} != plain "
                                   f"{want.tolist()}")
    key_thr = {}
    for name, (col, exp) in columns.items():
        plan = col.plan(dev)
        thr17 = column_thresholds(exp, 17)
        key_thr[name] = thr17
        thrs = [thr17] + ([column_thresholds(exp, 2049)]
                          if name == "f64_mixed_alp_rd" else [])
        for thr in thrs:
            thr_t = thresholds_tensor(thr, plan)
            for call in engine.key_calls(plan):
                got = call.counts(thr_t, torch.zeros(
                    len(thr) + 1, dtype=torch.int64, device=dev))
                want = call.counts_plain(thr_t)
                err = int_err(got, want)
                errors["key_counts"] = max(errors["key_counts"], err)
                if err != 0.0:
                    raise RuntimeError(f"{name}: key_counts ({len(thr)} "
                                       f"thresholds) bw={call.bw} differs "
                                       f"from its plain version")
        out = torch.zeros((plan.n_vectors, 2), dtype=plan.bits_dtype,
                          device=dev)
        for call in engine.key_calls(plan):
            call.extremes(out)
            err = int_err(out[call.rows], call.extremes_plain())
            errors["key_extremes"] = max(errors["key_extremes"], err)
            if err != 0.0:
                raise RuntimeError(f"{name}: key_extremes bw={call.bw} "
                                   f"differs from its plain version")
        key_range = (int(thr17[4]), int(thr17[12]))
        for call in engine.sum_calls(plan, key_range):
            got = call.launch(kes.totals(plan.bits_dtype, dev))
            want = call.plain()
            err = int_err(got, want)
            errors[call.kernel] = max(errors[call.kernel], err)
            if err != 0.0:
                raise RuntimeError(f"{name}: {call.kernel} with the key "
                                   f"range {key_range} differs from its "
                                   f"plain version")
        # K17 at a real first pass (every bracket the key extent), at the
        # first later pass whose brackets differ (narrowed by the snap),
        # and at R disjoint brackets inside the column's extent
        seen = rank_passes(engine, alp_tpu_torch, col)
        later = [p for p in seen[1:] if len(np.unique(p[1], axis=0)) > 1]
        R, T = RANK_TIMED
        checks = [("first pass", *seen[0])] + [
            ("later pass", *p) for p in later[:1]] + [
            ("disjoint", column_thresholds(exp, T), disjoint_brackets(exp, R))]
        for label, thr, br in checks:
            thr_t, br_t = (thresholds_tensor(thr, plan),
                           thresholds_tensor(br, plan))
            for call in engine.key_calls(plan):
                got = call.rank_pass(thr_t, br_t, *kkeys.rank_outputs(
                    len(thr), len(br), plan.bits_dtype, dev))
                want = call.rank_pass_plain(thr_t, br_t)
                err = max(int_err(a, b) for a, b in zip(got, want))
                errors["rank_pass"] = max(errors["rank_pass"], err)
                if err != 0.0:
                    raise RuntimeError(f"{name}: rank_pass at the {label} "
                                       f"({len(thr)} thresholds, {len(br)} "
                                       f"brackets) bw={call.bw} differs "
                                       f"from its plain version")
        print(f"  {name}: K15 (17{' and 2049' if len(thrs) > 1 else ''} "
              f"thresholds), K16, K17 ("
              + ", ".join(f"{label}: {len(thr)} thresholds, {len(br)} "
                          f"brackets" for label, thr, br in checks)
              + ") and the filtered SUM == plain", flush=True)
    for name, (col, exp) in columns.items():
        plan = col.plan(dev)
        W = kes.WINDOWS[plan.bits_dtype]
        sums_t = torch.zeros((plan.n_vectors, W + 3), dtype=torch.int64,
                             device=dev)
        keys_t = torch.zeros((plan.n_vectors, 2), dtype=plan.bits_dtype,
                             device=dev)
        for call in engine.group_calls(plan):
            call.vector_sums(sums_t, keys_t)
            want_s, want_k = call.vector_sums_plain()
            err = max(int_err(sums_t[call.rows], want_s),
                      int_err(keys_t[call.rows], want_k))
            errors["vector_sum_extremes"] = max(
                errors["vector_sum_extremes"], err)
            if err != 0.0:
                raise RuntimeError(f"{name}: vector_sum_extremes bw="
                                   f"{call.bw} differs from its plain "
                                   f"version")
        for G, ordered in ((16, False), (65536, False), (ORDERED_RUNS, True)):
            kv = column_group_keys(plan, G, ordered, args.seed + G)
            for call in engine.group_calls(plan):
                gk = kv[call.rows].contiguous()
                got = call.group_reduce(gk, G, *kgroup.group_outputs(
                    G, plan.bits_dtype, dev))
                want = call.group_reduce_plain(gk, G)
                err = max(int_err(a, b) for a, b in zip(got, want))
                errors["group_reduce"] = max(errors["group_reduce"], err)
                if err != 0.0:
                    raise RuntimeError(f"{name}: group_reduce at G={G} "
                                       f"({'ordered' if ordered else 'random'}"
                                       f" keys) bw={call.bw} differs from "
                                       f"its plain version")
            del kv
        print(f"  {name}: K18 and K19 (G = 16, 65536 and {ORDERED_RUNS} "
              f"ordered runs) == plain on every bucket", flush=True)
    for name, (col, _) in columns.items():
        plan = col.plan(dev)
        checked = []
        for b in plan.buckets:
            if b.scheme != 2:
                continue
            got = kffor.unffor(b.args[0], b.bw, b.args[1])
            err = int_err(got, unffor_unpack(b.args[0], b.args[1], b.bw))
            errors["unffor"] = max(errors["unffor"], err)
            if plan.f64:
                got = falp.variant_sum_f64(b.args[0], b.bw, *b.args[1:])
                want = falp.variant_sum_plain(b.args[0], b.bw, *b.args[1:])
                e20 = int_err(got.view(torch.int32), want.view(torch.int32))
                errors["variant_sum_f64"] = max(errors["variant_sum_f64"],
                                                e20)
                err = max(err, e20)
            if err != 0.0:
                raise RuntimeError(f"{name}: unffor or variant_sum_f64 bw="
                                   f"{b.bw} differs from its plain version")
            checked.append(f"ALP bw {b.bw}")
        scratch, _ = plan.decode_rd()
        rd = [b for b in plan.buckets if b.scheme != 2]
        for b, rows_b in zip(rd, plan._rd_layout[0]):
            want = scratch[rows_b]
            left = glue_left(want, b.bw)
            k = "rd_glue_f64" if plan.f64 else "rd_glue_f32"
            got = getattr(falp, k)(b.args[0], b.bw, left)
            err = max(int_err(got, want),
                      int_err(got, falp.rd_glue_plain(b.args[0], b.bw, left)))
            errors[k] = max(errors[k], err)
            if err != 0.0:
                raise RuntimeError(f"{name}: {k} rbw={b.bw} differs from "
                                   f"the decode or its plain version")
            checked.append(f"ALP_RD rbw {b.bw}")
        del scratch
        if plan.f64:
            bits = plan.run().view(torch.int64)
            err = int_err(kgroup.key_extremes_bits_f64(bits),
                          kgroup.key_extremes_bits_plain(bits))
            errors["key_extremes_bits"] = max(errors["key_extremes_bits"],
                                              err)
            if err != 0.0:
                raise RuntimeError(f"{name}: key_extremes_bits differs from "
                                   f"its plain version")
            checked.append("decoded bits")
            del bits
        print(f"  {name}: K20-K23 == plain on {', '.join(checked)}",
              flush=True)
    dc_calls = {}
    for name in columns:
        got, calls = record_dc_calls(
            lambda: alp_tpu_torch.compress_device(columns[name][1]))
        if got.to_bytes() != host_blobs[name]:
            raise RuntimeError(f"{name}: compress_device blob differs")
        for k, _, _, err, _, _ in calls:
            errors[k] = max(errors[k], err)
            if err != 0.0:
                raise RuntimeError(f"{name}: {k} differs from its plain "
                                   f"version (max abs err {err})")
        if name in DC_TIMED + DC_TIMED32:
            dc_calls[name] = calls
        print(f"  {name}: {len(calls)} K9-K14 calls == plain", flush=True)
    phase("kernels", t0, "every bucket of every column: kernel bits == "
          "plain bits, SUM totals == plain totals (also with a key range), "
          "K15 bins, K16 keys, K17 bins and keys and K18/K19 totals and "
          "keys == plain, K20-K23 == plain (K21 == the decode), every "
          "K9-K14 call of compress_device == plain (tolerance 0)")

    # 10. timing at the 256 MiB shapes
    t0 = time.perf_counter()
    timed = {"falp_decode_f64": list(BENCH_PROFILES),
             "falp_decode_f32": ["f32_alp"],
             "rd_decode_dict_f64": ["f64_alp_rd"],
             "rd_decode_dict_f32": ["f32_alp_rd"]}
    rows = []
    for k, names in timed.items():
        ms, plain_ms, bound_ms, copy_ms, by = [], [], [], [], "bytes"
        decoded_gbs = []
        for name in names:
            plan = plans[name]
            col = columns[name][0]
            vdt = torch.float64 if plan.f64 else torch.float32
            out = torch.empty((col.n_vectors, VECTOR), dtype=vdt, device=dev)
            mine = [b for b in plan.buckets if kernel_of(plan, b) == k]
            t_k = cuda_ms(lambda: [plan.launch(b, out) for b in mine], 20)
            t_p = cuda_ms(lambda: [run_plain(plan, b, out) for b in mine], 3)
            src = out.clone()
            dst = torch.empty_like(out)
            t_c = cuda_ms(lambda: dst.copy_(src), 20)
            moved = sum(bucket_bytes(b, out.element_size()) for b in mine)
            n_vals = sum(b.n_vectors for b in mine) * VECTOR
            # falp: one int->float conversion and one multiply per value
            ops = 2 * n_vals if k.startswith("falp") else 0
            b_bytes = moved / HBM_BYTES_PER_S * 1e3
            b_ops = ops / FLOPS_PER_S * 1e3
            by = "bytes" if b_bytes >= b_ops else "operations"
            ms.append(t_k)
            plain_ms.append(t_p)
            bound_ms.append(max(b_bytes, b_ops))
            copy_ms.append(t_c)
            print(f"  {k} on {name}: {len(mine)} launches/decode, "
                  f"{moved} bytes, kernel {t_k:.4f} ms, plain {t_p:.4f} ms,"
                  f" bound {max(b_bytes, b_ops):.4f} ms ({by}), "
                  f"copy_ {t_c:.4f} ms, moved {moved / t_k / 1e6:.1f} GB/s, "
                  f"decoded {n_vals * out.element_size() / t_k / 1e6:.1f} "
                  f"GB/s", flush=True)
            decoded_gbs.append(n_vals * out.element_size() / t_k / 1e6)
            del out, src, dst
        print(f"  {k}: mean decoded GB/s over {names}: "
              f"{float(np.mean(decoded_gbs)):.1f}", flush=True)
        rows.append({
            "name": k, "route": "cuda", "source": "alp_tpu_torch/csrc/falp.cu",
            "replaces": KERNELS[k][0], "also_replaces": KERNELS[k][1],
            "launches": main_launches[k], "max_abs_err": errors[k],
            "ms": float(np.mean(ms)), "plain_ms": float(np.mean(plain_ms)),
            "bound_ms": float(np.mean(bound_ms)), "bound_by": by,
            "library_ms": None,
            "yardstick_ms": float(np.mean(copy_ms)),
            "yardstick": "Tensor.copy_ of the decoded bytes (not the same "
                         "function: no PyTorch call decodes ALP)",
            "timed_on": names,
        })
    timed = {"falp_decode_f64_exact_sum": list(BENCH_PROFILES),
             "falp_decode_f32_exact_sum": ["f32_alp"],
             "exact_sum_f64": ["f64_alp_rd"],
             "exact_sum_f32": ["f32_alp_rd"]}
    for k, names in timed.items():
        ms, plain_ms, bound_ms, sum_ms, filtered_ms = [], [], [], [], []
        by_bytes, by_ops = [], []
        for name in names:
            col = columns[name][0]
            plan = col.plan(dev)
            mine = [c for c in engine.sum_calls(plan) if c.kernel == k]
            out = kes.totals(plan.bits_dtype, dev)
            t_k = cuda_ms(lambda: [c.launch(out) for c in mine], 20)
            key_range = (int(key_thr[name][4]), int(key_thr[name][12]))
            where = [c for c in engine.sum_calls(plan, key_range)
                     if c.kernel == k]
            t_f = cuda_ms(lambda: [c.launch(out) for c in where], 20)
            filtered_ms.append(t_f)
            t_p = cuda_ms(lambda: [c.plain() for c in mine], 3)
            values = plan.run()
            t_s = cuda_ms(values.sum, 20)
            moved = sum(call_bytes(plan, c) for c in mine)
            counted = [sum_ops(plan, c, values.view(plan.bits_dtype))
                       for c in mine]
            n_vals = sum(c[0] for c in counted)
            int_ops = sum(c[1] for c in counted)
            fl_ops = sum(c[2] for c in counted)
            fl_rate = FP64_FLOPS_PER_S if plan.f64 else FLOPS_PER_S
            b_bytes = moved / HBM_BYTES_PER_S * 1e3
            b_ops = max(int_ops / int32_per_s, fl_ops / fl_rate) * 1e3
            ms.append(t_k)
            plain_ms.append(t_p)
            bound_ms.append(max(b_bytes, b_ops))
            by_bytes.append(b_bytes)
            by_ops.append(b_ops)
            sum_ms.append(t_s)
            print(f"  {k} on {name}: {len(mine)} launches/query, {moved} "
                  f"bytes, {n_vals} values, {int_ops} int ops, {fl_ops} "
                  f"float ops, kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                  f"bound {max(b_bytes, b_ops):.4f} ms (bytes "
                  f"{b_bytes:.4f} ms, operations {b_ops:.4f} ms), "
                  f"torch.sum {t_s:.4f} ms, {n_vals / t_k / 1e6:.1f} "
                  f"Gvalues/s; with the key range {key_range} (filtered "
                  f"instantiation) {t_f:.4f} ms", flush=True)
            del values, out
        by = "bytes" if sum(by_bytes) >= sum(by_ops) else "operations"
        rows.append({
            "name": k, "route": "cuda",
            "source": "alp_tpu_torch/csrc/exact_sum.cu",
            "replaces": SUM_KERNELS[k], "also_replaces": [],
            "launches": sum_launches[k], "max_abs_err": errors[k],
            "ms": float(np.mean(ms)), "plain_ms": float(np.mean(plain_ms)),
            "bound_ms": float(np.mean(bound_ms)), "bound_by": by,
            "library_ms": None,
            "yardstick_ms": float(np.mean(sum_ms)),
            "yardstick": "torch.sum of the decoded values (not the same "
                         "function: rounded, not exact; no PyTorch call "
                         "sums exactly)",
            "timed_on": names,
            "filtered_ms": float(np.mean(filtered_ms)),
        })
    for k, (src, site, others, timed_on) in DC_KERNELS.items():
        ms, plain_ms, bound_ms, copy_ms, b_by_bytes, b_by_ops = ([] for _ in
                                                                  range(6))
        per_col = []
        for name in timed_on:
            mine = [c for c in dc_calls[name] if c[0] == k]
            if not mine:      # bw 0 packs nothing; ALP_RD encodes nothing
                print(f"  {k} on {name}: no launch", flush=True)
                continue
            kernels = [ln for c in mine for ln in c[4]]
            t_k = cuda_ms(lambda: [falp._launch(e, d, *a)
                                   for e, d, a in kernels], 10)
            t_p = cuda_ms(lambda: [dc_plain(k, c[1], c[2]) for c in mine],
                          2)
            src_t = mine[0][1][0]
            dst = torch.empty_like(src_t)
            t_c = cuda_ms(lambda: dst.copy_(src_t), 10)
            work = [dc_work(k, c[1], c[2]) for c in mine]
            moved, fp_ops, fp32_ops, int_ops = (sum(w[i] for w in work)
                                                for i in range(4))
            b_bytes = moved / HBM_BYTES_PER_S * 1e3
            b_ops = max(fp_ops / fp64_per_s, fp32_ops / fp32_per_s,
                        int_ops / int32_per_s) * 1e3
            ms.append(t_k)
            plain_ms.append(t_p)
            bound_ms.append(max(b_bytes, b_ops))
            copy_ms.append(t_c)
            b_by_bytes.append(b_bytes)
            b_by_ops.append(b_ops)
            per_col.append(len(kernels))
            print(f"  {k} on {name}: {len(kernels)} launches/compress, "
                  f"{moved} bytes, {fp_ops} FP64 ops, {fp32_ops} FP32 ops, "
                  f"{int_ops} int ops, kernel "
                  f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                  f"{max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f} ms, "
                  f"operations {b_ops:.4f} ms), share "
                  f"{max(b_bytes, b_ops) / t_k:.1%}, copy_ {t_c:.4f} ms",
                  flush=True)
            del dst
        by = "bytes" if sum(b_by_bytes) >= sum(b_by_ops) else "operations"
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": site,
            "also_replaces": others, "launches": dc_launches[k],
            "launches_per_column": per_col, "max_abs_err": errors[k],
            "ms": float(np.mean(ms)), "plain_ms": float(np.mean(plain_ms)),
            "bound_ms": float(np.mean(bound_ms)), "bound_by": by,
            "library_ms": None,
            "yardstick_ms": float(np.mean(copy_ms)),
            "yardstick": "Tensor.copy_ of the first call's main input (not "
                         "the same function: no PyTorch call encodes, "
                         "packs or scores ALP)",
            "timed_on": [n for n in timed_on
                         if any(c[0] == k for c in dc_calls[n])],
        })
    del dc_calls
    key_timed = [*BENCH_PROFILES, "f64_alp_rd", "f32_alp", "f32_alp_rd"]
    for k, (site, others) in KEY_KERNELS.items():
        cells = {}
        for E in ((2, 17) if k == "key_counts" else (None,)):
            ms, plain_ms, bound_ms, yard_ms, b_bytes_l, b_ops_l = (
                [] for _ in range(6))
            for name in key_timed:
                col, exp = columns[name]
                plan = col.plan(dev)
                calls = engine.key_calls(plan)
                bits = plan.run().view(plan.bits_dtype)
                if E is None:
                    out = torch.empty((plan.n_vectors, 2),
                                      dtype=plan.bits_dtype, device=dev)
                    t_k = cuda_ms(lambda: [c.extremes(out) for c in calls],
                                  20)
                    t_p = cuda_ms(lambda: [c.extremes_plain()
                                           for c in calls], 3)
                    bk = biased_keys(bits)
                    t_y = cuda_ms(lambda: (bk.amin(dim=1), bk.amax(dim=1)),
                                  20)
                else:
                    thr = column_thresholds(exp, E)
                    thr_t = thresholds_tensor(thr, plan)
                    out = torch.zeros(E + 1, dtype=torch.int64, device=dev)
                    t_k = cuda_ms(lambda: [c.counts(thr_t, out)
                                           for c in calls], 20)
                    t_p = cuda_ms(lambda: [c.counts_plain(thr_t)
                                           for c in calls], 3)
                    bk = biased_keys(bits.reshape(-1)[:plan.n_values])
                    bthr = bias(thr_t)
                    t_y = cuda_ms(lambda: torch.bincount(
                        torch.bucketize(bk, bthr), minlength=E + 1), 20)
                work = [key_work(plan, c, E) for c in calls]
                moved, int_ops, fl_ops = (sum(w[i] for w in work)
                                          for i in range(3))
                b_bytes = moved / HBM_BYTES_PER_S * 1e3
                b_ops = max(int_ops / int32_per_s, fl_ops / (
                    fp64_per_s if plan.f64 else fp32_per_s)) * 1e3
                ms.append(t_k)
                plain_ms.append(t_p)
                bound_ms.append(max(b_bytes, b_ops))
                yard_ms.append(t_y)
                b_bytes_l.append(b_bytes)
                b_ops_l.append(b_ops)
                print(f"  {k}{'' if E is None else f' E={E}'} on {name}: "
                      f"{len(calls)} launches/pass, {moved} bytes, "
                      f"{int_ops} int ops, {fl_ops} float ops, kernel "
                      f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                      f"{max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f} "
                      f"ms, operations {b_ops:.4f} ms), share "
                      f"{max(b_bytes, b_ops) / t_k:.1%}, yardstick "
                      f"{t_y:.4f} ms", flush=True)
                del bits, bk, out
            cells[E] = {
                "ms": float(np.mean(ms)), "plain_ms": float(np.mean(plain_ms)),
                "bound_ms": float(np.mean(bound_ms)),
                "bound_by": ("bytes" if sum(b_bytes_l) >= sum(b_ops_l)
                             else "operations"),
                "yardstick_ms": float(np.mean(yard_ms))}
        main_cell = cells[2] if k == "key_counts" else cells[None]
        row = {
            "name": k, "route": "cuda", "source": "alp_tpu_torch/csrc/keys.cu",
            "replaces": site, "also_replaces": others,
            "launches": query_launches[k], "max_abs_err": errors[k],
            **main_cell, "library_ms": None,
            "yardstick": ("torch.bucketize + torch.bincount of the decoded "
                          "keys" if k == "key_counts" else
                          "amin/amax over dim=1 of the decoded keys")
            + " (not the same function: no PyTorch call reads the "
              "compressed form)",
            "timed_on": key_timed}
        if k == "key_counts":
            row["E"] = 2
            row.update({f"{f}_E17": v for f, v in cells[17].items()})
        rows.append(row)
    R, T = RANK_TIMED
    for k, (site, others) in RANK_KERNELS.items():
        cells = {}
        for label in ("disjoint", "later"):
            ms, plain_ms, bound_ms, old_ms, yard_ms, b_bytes_l, b_ops_l = (
                [] for _ in range(7))
            for name in key_timed:
                col, exp = columns[name]
                plan = col.plan(dev)
                calls = engine.key_calls(plan)
                bits = plan.run().view(plan.bits_dtype)
                bk = biased_keys(bits.reshape(-1)[:plan.n_values])
                del bits
                if label == "disjoint":
                    thr, br = (column_thresholds(exp, T),
                               disjoint_brackets(exp, R))
                else:
                    thr, br = later_pass_case(torch.sort(bk).values, R, T)
                thr_t, br_t = (thresholds_tensor(thr, plan),
                               thresholds_tensor(br, plan))
                outs = kkeys.rank_outputs(len(thr), R, plan.bits_dtype, dev)
                t_k = cuda_ms(lambda: [c.rank_pass(thr_t, br_t, *outs)
                                       for c in calls], 20)
                t_p = cuda_ms(lambda: [c.rank_pass_plain(thr_t, br_t)
                                       for c in calls], 3)
                for c in calls:                # the timed inputs, by bits
                    got = c.rank_pass(thr_t, br_t, *kkeys.rank_outputs(
                        len(thr), R, plan.bits_dtype, dev))
                    want = c.rank_pass_plain(thr_t, br_t)
                    if not all(map(torch.equal, got, want)):
                        raise RuntimeError(f"{name}: {k} {label} differs "
                                           f"from its plain version")
                bthr, bbr = bias(thr_t), bias(br_t)
                top = torch.iinfo(bk.dtype).max
                bottom = torch.iinfo(bk.dtype).min

                def yardstick():
                    torch.bincount(torch.bucketize(bk, bthr),
                                   minlength=len(thr) + 1)
                    for r in range(R):
                        inside = (bk >= bbr[r, 0]) & (bk <= bbr[r, 1])
                        torch.where(inside, bk, top).amin()
                        torch.where(inside, bk, bottom).amax()
                t_y = cuda_ms(yardstick, 5)
                hits = bracket_hits(plan, bk, sorted(set(map(
                    tuple, bbr.tolist()))))
                rank, split = rank_work(plan, bk, thr, br)
                work = [key_work(plan, c, len(thr), R, rank=rank)
                        for c in calls]
                # the first design's count: a binary search and every
                # bracket's compares a value
                old = [key_work(plan, c, len(thr), R, hits) for c in calls]
                moved, int_ops, fl_ops = (sum(w[i] for w in work)
                                          for i in range(3))
                b_bytes = moved / HBM_BYTES_PER_S * 1e3
                fp_ms = fl_ops / (fp64_per_s if plan.f64 else fp32_per_s)
                b_ops = max(int_ops / int32_per_s, fp_ms) * 1e3
                b_old = max(b_bytes, max(sum(w[1] for w in old) / int32_per_s,
                                         fp_ms) * 1e3)
                ms.append(t_k)
                plain_ms.append(t_p)
                bound_ms.append(max(b_bytes, b_ops))
                old_ms.append(b_old)
                yard_ms.append(t_y)
                b_bytes_l.append(b_bytes)
                b_ops_l.append(b_ops)
                print(f"  {k} {label} R={R} T={len(thr)} on {name}: "
                      f"{len(calls)} launches/pass, {moved} bytes, "
                      f"{int(hits.sum())} values inside a bracket, "
                      f"{split} (value, cut) pairs where a "
                      f"bracket end splits the value's bin, {int_ops} int "
                      f"ops, {fl_ops} float "
                      f"ops, kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
                      f"{max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f} "
                      f"ms, operations {b_ops:.4f} ms), share "
                      f"{max(b_bytes, b_ops) / t_k:.1%}, bound by the first "
                      f"design's count {b_old:.4f} ms (share "
                      f"{b_old / t_k:.1%}),"
                      f" yardstick {t_y:.4f} ms", flush=True)
                del bk, outs, hits, split
            cells[label] = {
                "ms": float(np.mean(ms)), "plain_ms": float(np.mean(plain_ms)),
                "bound_ms": float(np.mean(bound_ms)),
                "bound_by": ("bytes" if sum(b_bytes_l) >= sum(b_ops_l)
                             else "operations"),
                "bound_ms_all_brackets": float(np.mean(old_ms)),
                "yardstick_ms": float(np.mean(yard_ms))}
        rows.append({
            "name": k, "route": "cuda", "source": "alp_tpu_torch/csrc/keys.cu",
            "replaces": site, "also_replaces": others,
            "launches": quantile_launches[k], "max_abs_err": errors[k],
            **cells["disjoint"], "library_ms": None,
            "yardstick": "torch.bucketize + torch.bincount and a masked "
                         "amin/amax a bracket over the decoded keys (not the "
                         "same function: no PyTorch call reads the "
                         "compressed form)",
            "timed_on": key_timed, "R": R, "T": T,
            **{f"{f}_later": v for f, v in cells["later"].items()}})
    for k, site in GROUP_KERNELS.items():
        cells = {}
        # K19: random ids at G = 16 (shared counters) and 65,536 (device
        # memory), and 16 ordered runs (whole warps of one group)
        for G, ordered in (((None, False),) if k == "vector_sum_extremes"
                           else ((16, False), (65536, False), (16, True))):
            ms, plain_ms, bound_ms, yard_ms, b_bytes_l, b_ops_l = (
                [] for _ in range(6))
            for name in key_timed:
                col, exp = columns[name]
                plan = col.plan(dev)
                calls = engine.group_calls(plan)
                bits = plan.run().view(plan.bits_dtype)
                W = kes.WINDOWS[plan.bits_dtype]
                if G is None:
                    sums_t = torch.empty((plan.n_vectors, W + 3),
                                         dtype=torch.int64, device=dev)
                    keys_t = torch.empty((plan.n_vectors, 2),
                                         dtype=plan.bits_dtype, device=dev)
                    t_k = cuda_ms(lambda: [c.vector_sums(sums_t, keys_t)
                                           for c in calls], 20)
                    t_p = cuda_ms(lambda: [c.vector_sums_plain()
                                           for c in calls], 3)
                    work = [group_work(plan, c, bits, "sums") for c in calls]
                    extra = 0
                    bk = biased_keys(bits)
                    vals = plan.run()
                    t_y = cuda_ms(lambda: (vals.sum(dim=1), bk.amin(dim=1),
                                           bk.amax(dim=1)), 20)
                    del vals
                else:
                    kv = column_group_keys(plan, G, ordered, args.seed + G)
                    gks = [kv[c.rows].contiguous() for c in calls]
                    outs = kgroup.group_outputs(G, plan.bits_dtype, dev)
                    t_k = cuda_ms(lambda: [c.group_reduce(gk, G, *outs)
                                           for c, gk in zip(calls, gks)], 20)
                    t_p = cuda_ms(lambda: [c.group_reduce_plain(gk, G)
                                           for c, gk in zip(calls, gks)], 3)
                    for c, gk in zip(calls, gks):  # the timed inputs, by bits
                        got = c.group_reduce(gk, G, *kgroup.group_outputs(
                            G, plan.bits_dtype, dev))
                        if not all(map(torch.equal, got,
                                       c.group_reduce_plain(gk, G))):
                            raise RuntimeError(f"{name}: {k} G={G} "
                                               f"ordered={ordered} differs "
                                               f"from its plain version")
                    work = [group_work(plan, c, bits, "groups")
                            for c in calls]
                    extra = G * ((W + 4) * 8 + 2 * bits.element_size())
                    vals = plan.run().reshape(-1)[:plan.n_values]
                    bk = biased_keys(bits.reshape(-1)[:plan.n_values])
                    gid = kv.reshape(-1)[:plan.n_values].long()

                    def yardstick():
                        torch.zeros(G, dtype=vals.dtype, device=dev
                                    ).index_add_(0, gid, vals)
                        for how in ("amin", "amax"):
                            torch.zeros(G, dtype=bk.dtype, device=dev
                                        ).scatter_reduce_(0, gid, bk, how,
                                                          include_self=False)
                    t_y = cuda_ms(yardstick, 5)
                    del kv, gks, vals, gid
                moved, int_ops, fl_ops = (sum(w[i] for w in work)
                                          for i in range(3))
                moved += extra
                b_bytes = moved / HBM_BYTES_PER_S * 1e3
                b_ops = max(int_ops / int32_per_s, fl_ops / (
                    fp64_per_s if plan.f64 else fp32_per_s)) * 1e3
                ms.append(t_k)
                plain_ms.append(t_p)
                bound_ms.append(max(b_bytes, b_ops))
                yard_ms.append(t_y)
                b_bytes_l.append(b_bytes)
                b_ops_l.append(b_ops)
                print(f"  {k}{'' if G is None else f' G={G}'}"
                      f"{' ordered' if ordered else ''} on {name}: "
                      f"{len(calls)} launches/pass, {moved} bytes, {int_ops} "
                      f"int ops, {fl_ops} float ops, kernel {t_k:.4f} ms, "
                      f"plain {t_p:.4f} ms, bound {max(b_bytes, b_ops):.4f} "
                      f"ms (bytes {b_bytes:.4f} ms, operations {b_ops:.4f} "
                      f"ms), share {max(b_bytes, b_ops) / t_k:.1%}, "
                      f"yardstick {t_y:.4f} ms", flush=True)
                del bits, bk
            cells[G, ordered] = {
                "ms": float(np.mean(ms)), "plain_ms": float(np.mean(plain_ms)),
                "bound_ms": float(np.mean(bound_ms)),
                "bound_by": ("bytes" if sum(b_bytes_l) >= sum(b_ops_l)
                             else "operations"),
                "yardstick_ms": float(np.mean(yard_ms))}
        row = {
            "name": k, "route": "cuda",
            "source": "alp_tpu_torch/csrc/group.cu",
            "replaces": site or "alp_tpu/engine.py:1920",
            "also_replaces": [],
            "launches": group_launches[k], "max_abs_err": errors[k],
            **cells[None if k == "vector_sum_extremes" else 16, False],
            "library_ms": None,
            "yardstick": ("a row sum and amin/amax over dim=1 of the "
                          "decoded values and keys"
                          if k == "vector_sum_extremes" else
                          "index_add_ of the decoded values and "
                          "scatter_reduce amin/amax of their keys by group")
            + " (not the same function: rounded, not exact; no PyTorch call "
              "reads the compressed form)",
            "timed_on": key_timed}
        if k == "group_reduce":
            row["replaces_note"] = ("no pl.pallas_call: the XLA grouped "
                                    "passes _mxu_scan (alp_tpu/engine.py:1920)"
                                    " and _groupby_chunk_f64/_f32 (:1735, "
                                    ":1784)")
            row["G"] = 16
            row.update({f"{f}_G65536": v
                        for f, v in cells[65536, False].items()})
            row.update({f"{f}_G16_ordered": v
                        for f, v in cells[16, True].items()})
        rows.append(row)
    rows += bench_rows(plans, columns, dev, errors, bench_launches,
                       int32_per_s, fp64_per_s, fp32_per_s)
    phase("timing", t0)
    phase("total", t_all)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
