"""CUDA-event ablations of the ALP_RD decode kernels K3/K4
``rd_decode_dict``, the exact-SUM kernels K5-K8, the (e, f) scorers
K11/K14, the key kernels K15 ``key_counts``, K16 ``key_extremes`` and K17
``rank_pass``, the grouped kernels K18 ``vector_sum_extremes`` and K19
``group_reduce`` and the bench's K20 ``variant_sum_f64`` on the card: what
each part of the kernels costs, and how the variants that were weighed
against them compare.

Run from the root of a checkout on a machine with one NVIDIA card::

    python3 kernel_ablations.py [kernel ...]

with kernels named as in ``KERNELS`` (``k7 k11``: only the variants that
change K7/K8 or K11/K14, and only their timings; none: every one; only
K3-K6: only the ALP_RD columns).  Each
variant is the sources of ``alp_tpu_torch/csrc`` with a few text edits
(``VARIANTS``: a string replaced, or a region from a start to an end),
built beside the library in the ignored ``alp_tpu_torch/_build/ablate/``
(every source compiled once, then the edited ones again, every source
where a header is edited, all in parallel) and timed on the 256 MiB
columns of ``chip_smoke.py`` (``COLUMNS``) at its timing shapes: K3/K4 on
the ALP_RD buckets of the f64 and f32 ALP_RD columns, K5-K8 on each
column's SUM calls (K5/K6 also filtered, at ``chip_smoke.py``'s key
range), K11/K14 on the launches of a ``compress_device``
of the column, by planning level, K15 at E = 2, 7 (the bench's histogram)
and 16 (``K15_E``; the few-threshold path against the search tree) and at
17 and 2048, K16, K17 at R = 8, T = 2048 on 8 disjoint brackets and on a
later pass (8 bands of 0.1 %), K18 on every bucket, K19 at G = 16 and
65,536 random ids and at 16 ordered runs, and K20 on the f64 ALP buckets.
K3/K4's variants (the ``k4`` family): the first design ``k4_staged`` (a
block a vector, both parts staged in shared memory behind a barrier, two
``unpack()`` calls a value; exact) and its splits ``k4_no_index`` (index
0), ``k4_no_unpack`` (the right part read as whole words) and
``k4_no_stage`` (the words read from device memory, no barrier; exact);
over the kept K4 ``k4_register_dict`` (the dictionary in registers,
looked up by byte permutes; exact), ``k4_stream_f64`` (K3 on K4's lane
streams; exact), ``k4_kept_no_index`` and ``k4_kept_no_right`` (the
index or the right stream removed), and the sweeps ``k4_step_8``,
``k4_block_128`` / ``_512`` (exact); K3 is the first design unstaged, as
``k4_no_stage``.  K5/K6's (the
``k6`` family): the
first loop ``k6_first_loop`` (a block a row, 4 scalar loads a thread,
one ``add()`` of 4 values, a 64-bit pad test a value; exact) and its
splits ``k6_no_digits`` (the bits XOR-folded into one output) and
``k6_one_row_check`` (the pad test once a row; exact); over the kept loop
``k6_scalar_loads`` (the same values by 4-byte loads), ``k6_four_per_add``
and ``k6_vals_16`` (4 or 16 values an ``add()``), ``k6_block_256`` /
``_512``, and three other ``Acc::add``s, which change K5-K8 and K18:
``k6_multiply_add`` (the one before: the range tested a value, every warp
adding), ``k6_carry_add`` (the digit XORed with the sign mask, added by
64-bit adds with a carry in) and ``k6_fma_add`` (the sign as the
multipliers of two 32-bit multiply-adds), all exact; and
``k6_kept_no_digits``.
K7's variants: the first design's parts over the kept ones,
``k7_staged`` (a block a row, its words staged in shared memory, 4 values
a thread by ``unpack()``, with the kept exception path),
``k7_shared_exceptions`` (that loop with the exceptions patched through a
shared copy of the row: the whole first loop) and ``k7_select_digits``
(the first ``Acc::add``: it changes K5-K8 and K18 too); ``k7_slot_unpack``
(the lanes by ``unpack()`` of every slot), ``k7_early_csr`` (a row's CSR
range loaded before its stream, not after: longer live ranges), the sweeps ``k7_step_2`` /
``_8``, ``k7_block_128`` / ``_512`` and ``k7_block_512_step_8``, all
exact; ``k7_no_digits`` (the
decoded bits XOR-folded into one output) and ``k7_no_exceptions``; and
``k7_no_stage``, a split of the first loop (its words read straight from
device memory).  K11's: ``k11_warp_task`` (the first design, a warp a
task), its splits ``k11_no_reduce`` (only lane 0's trial, no shuffles) and
``k11_no_index`` (a 32-bit task / C), ``k11_one_trial`` (one sample a
task: the task's own cost), and the sweeps ``k11_unroll_1`` / ``_8`` /
``_32``, ``k11_block_128`` / ``_512`` (shared pairs), ``k11_own_64`` /
``_256`` (each segment's own) and ``k11_stride_32`` (the samples
in shared memory at a stride of 32: bank conflicts).  K18's variants:
``k18_atomic_settle`` (the first design's settle, 64-bit shared atomics
into a row, on the present row loop; exact), ``k18_256_threads`` (blocks
of 256, 4 values a thread; exact), ``k18_no_digits`` and ``k18_no_keys``
(the digit sums or the key extremes removed).  K20's:
``k20_slot_unpack`` (the first design, ``unpack()`` for every slot;
exact), ``k20_word_loop`` (the lane word by word, one field at a time;
exact), ``k20_direct`` (each field's words loaded where it is taken;
exact), ``k20_magic_convert`` (the int64 -> double convert by the 2^52
magic add where |m| < 2^51; exact) and ``k20_no_convert`` (the convert
removed).  A variant marked exact must give its plain version's outputs
bit for bit (the script fails otherwise); the ablations (a part removed)
give wrong outputs and are timed only.  Prints the card and its power
limit, the ptxas line of each rebuilt kernel, the SASS of K4's, K6's,
K7's, K11's and K20's loops in each of their variants (``cuobjdump
-sass``: each loop's and the whole kernel's instructions, those of
``SASS_OPS``, and the instructions a unit and a value: K4's store, K6's
load (``UNIT_VALUES``), K20's float add, K7's and K11's int64 -> double
convert), a
line a column and a JSON object of every time, in milliseconds (CUDA
events, 20 launches after a warm-up, as ``chip_smoke.cuda_ms``).
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
BUILD = ROOT / "alp_tpu_torch" / "_build" / "ablate"
COLUMNS = ("bench_bw11_city_temperature", "bench_bw20_food_prices",
           "bench_bw30_bitcoin", "bench_bw42_nyc29", "bench_bw0_gov26",
           "f64_alp_rd", "f32_alp", "f32_alp_rd")
K15_E = (2, 7, 16, 17, 2048)        # K15's thresholds a timing

# K17's row loop and its parts, as csrc/keys.cu has them
_RANK_CALL = "    rank_keys(key, real, tab);\n"
_BRACKETS = "    if (real[j] && key[j] >= t.ulo && key[j] <= t.uhi) {"
_SEARCH = "  t.tree.bins(key, p);"
_BINS = "    count_bin(real[j], p[j], t.hist);"
_BOUNDS = "__global__ void __launch_bounds__(kThreads)\nrank_pass_kernel("
_TREE_LOOP = """    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        at[j] = 2 * at[j] + (node[at[j]] < key[j]);
    }"""
_TREE_BUILD = "      w[at] = s < n ? thr[s] : static_cast<U>(~U(0));"
_WARP_PATH = "    if (__all_sync(kFull, real && g == g0))\n      add_warp(g0, b);"

# the key kernels' row loop (vector.cuh), K15's few-threshold path and
# K16's merge (keys.cu)
_PATCH = ("      if (marked && ((mk[k >> 5] >> (k & 31)) & 1u))\n"
          "        b = src.patch(buf, ra.rw, xv[k], k);\n")
_VALUE = "      U b = src.value(buf, ra.rw, k);\n"
_STORE_FIRST = ("  store_exceptions<T>(src, ra.e0, ra.e1, marks, xval, ra.xk, "
                "ra.xp);\n")
_STORE_NEXT = """    store_exceptions<T>(src, ra.e0n, ra.e1n,
                        marks + 32 * ((it + 1) % kMarks),
                        xval + ((it + 1) & 1) * kVector, ra.xkn, ra.xpn);
"""
_SMALL = "  if (E <= kSmall) {"
_K_SMALL = "constexpr int kSmall = 2;"
_COUNT_SMALL = """  U k[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    k[j] = real[j] ? key[j] : U(0);
    above[0] += real[j];
  }
#pragma unroll
  for (int e = 0; e < kSmall; ++e) {
    const U t = th[e];
#pragma unroll
    for (int j = 0; j < N; ++j) above[e + 1] += k[j] > t;
  }"""
_K16_SLOTS = """  __shared__ U wlo[kKeyWarps], whi[kKeyWarps];   // a warp's pair
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
"""
_K16_MERGE = """    if (lane == 0) {
      wlo[warp] = lo;
      whi[warp] = hi;
    }
    // the slots are written again only after the next row's barrier
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kKeyWarps; ++w) {
        lo = umin(lo, wlo[w]);
        hi = umax(hi, whi[w]);
      }
      out[2 * vec] = lo;
      out[2 * vec + 1] = hi;
    }
  });
}"""

# K18 (group.cu) and K20 (falp.cu), as the sources have them
_K18_STORE = "    acc.store(s.part[warp], &s.base[warp]);\n"
_K18_KEYS = """      if (real[j]) {
        lo = umin(lo, key[j]);
        hi = umax(hi, key[j]);
      }
"""
_K20_STREAM = """\
    alp::LaneStream<uint64_t> in(packed + vec * bw * kLanes64 + lane, bw);
    for (int s = 0; s < kSlots64; s += kSumStep) {
      float t[kSumStep];
#pragma unroll
      for (int q = 0; q < kSumStep; ++q) t[q] = cut(in.next());
#pragma unroll
      for (int q = 0; q < kSumStep; ++q) acc = __fadd_rn(acc, t[q]);
    }
"""
_K20_DECODE = """    return trunc_f32(Num<double>::bits(
        Num<double>::decode(static_cast<uint64_t>((b + u) * f), fr)));
"""

# K7 (exact_sum.cu) and K11 (score.cu), as the sources have them, and the
# first designs that kernel_ablations.py weighs against them
_K7_KERNEL = ("template <typename F, bool Filter>\n__global__ void "
              "__launch_bounds__(kLaneThreads)\nfalp_exact_sum_kernel(",
              "      acc.add(x, xok);\n    }\n  }\n  acc.finish(out);\n}\n")
_K7_ROWS = "  constexpr long long kRows = kLaneThreads / 32 * lane_rows<F>();"
# the first design's loop: a block a row, its words staged in shared
# memory, 4 values a thread by unpack(), the exceptions patched through a
# shared copy of the row
_K7_SHARED_EXCEPTIONS = 'template <typename F, bool Filter>\n__global__ void __launch_bounds__(kThreads)\nfalp_exact_sum_kernel(const typename Num<F>::U* __restrict__ packed, int bw,\n                      const typename Num<F>::U* __restrict__ base,\n                      const typename Num<F>::U* __restrict__ fact,\n                      const F* __restrict__ frac,\n                      const long long* __restrict__ rows,\n                      const long long* __restrict__ exc_ptr,\n                      const long long* __restrict__ exc_index,\n                      const typename Num<F>::U* __restrict__ exc_bits,\n                      long long n, long long n_values,\n                      typename Num<F>::U klo, typename Num<F>::U khi,\n                      long long* __restrict__ out) {\n  using U = typename Num<F>::U;\n  constexpr int S = Num<F>::S;\n  __shared__ U words[kVector];               // bw <= S: at most 1024 words\n  __shared__ U vals[kVector];\n  __shared__ long long row[Fixed<U>::W + 3];\n  zero_row<U>(row);\n  Acc<U> acc(row);\n  for (long long i = blockIdx.x; i < n; i += gridDim.x) {\n    __syncthreads();                         // the last vector is read\n    alp::stage<U, S>(words, packed + i * bw * (kVector / S), bw);\n    __syncthreads();\n    const U b0 = base[i], f = fact[i];\n    const F fr = frac[i];\n    const long long vec = rows[i];\n    U b[kPer];\n    bool ok[kPer];\n#pragma unroll\n    for (int r = 0; r < kPer; ++r) {\n      const int k = threadIdx.x + r * kThreads;\n      const U u = bw ? unpack<U, S>(words, bw, k) : U(0);\n      b[r] = Num<F>::bits(Num<F>::decode(static_cast<U>((b0 + u) * f), fr));\n      ok[r] = vec * kVector + k < n_values;\n    }\n    const long long e0 = exc_ptr[vec], e1 = exc_ptr[vec + 1];\n    if (e1 > e0) {                           // block-uniform\n#pragma unroll\n      for (int r = 0; r < kPer; ++r) vals[threadIdx.x + r * kThreads] = b[r];\n      __syncthreads();\n      for (long long e = e0 + threadIdx.x; e < e1; e += kThreads)\n        vals[exc_index[e] & (kVector - 1)] = exc_bits[e];\n      __syncthreads();\n#pragma unroll\n      for (int r = 0; r < kPer; ++r) b[r] = vals[threadIdx.x + r * kThreads];\n    }\n    if constexpr (Filter) {\n#pragma unroll\n      for (int r = 0; r < kPer; ++r)\n        ok[r] = ok[r] && selected<Filter>(b[r], klo, khi);\n    }\n    acc.add(b, ok);\n  }\n  acc.finish(out);\n}\n\n'
# the same loop with the kept exception path: the true bits added and the
# placeholder subtracted by the thread that loads the exception
_K7_STAGED = 'template <typename F, bool Filter>\n__global__ void __launch_bounds__(kThreads)\nfalp_exact_sum_kernel(const typename Num<F>::U* __restrict__ packed, int bw,\n                      const typename Num<F>::U* __restrict__ base,\n                      const typename Num<F>::U* __restrict__ fact,\n                      const F* __restrict__ frac,\n                      const long long* __restrict__ rows,\n                      const long long* __restrict__ exc_ptr,\n                      const long long* __restrict__ exc_index,\n                      const typename Num<F>::U* __restrict__ exc_bits,\n                      long long n, long long n_values,\n                      typename Num<F>::U klo, typename Num<F>::U khi,\n                      long long* __restrict__ out) {\n  using U = typename Num<F>::U;\n  constexpr int S = Num<F>::S;\n  __shared__ U words[kVector];               // bw <= S: at most 1024 words\n  __shared__ long long row[Fixed<U>::W + 3];\n  zero_row<U>(row);\n  Acc<U> acc(row);\n  for (long long i = blockIdx.x; i < n; i += gridDim.x) {\n    __syncthreads();                         // the last vector is read\n    alp::stage<U, S>(words, packed + i * bw * (kVector / S), bw);\n    __syncthreads();\n    const U b0 = base[i], f = fact[i];\n    const F fr = frac[i];\n    const long long vec = rows[i];\n    U b[kPer];\n    bool ok[kPer];\n#pragma unroll\n    for (int r = 0; r < kPer; ++r) {\n      const int k = threadIdx.x + r * kThreads;\n      const U u = bw ? unpack<U, S>(words, bw, k) : U(0);\n      b[r] = Num<F>::bits(Num<F>::decode(static_cast<U>((b0 + u) * f), fr));\n      ok[r] = vec * kVector + k < n_values;\n    }\n    if constexpr (Filter) {\n#pragma unroll\n      for (int r = 0; r < kPer; ++r)\n        ok[r] = ok[r] && selected<Filter>(b[r], klo, khi);\n    }\n    acc.add(b, ok);\n    const long long e0 = exc_ptr[vec], e1 = exc_ptr[vec + 1];\n    for (long long eb = e0; eb < e1; eb += kThreads) {   // block-uniform\n      const long long e = eb + threadIdx.x;\n      U x[2] = {0, 0};\n      bool xok[2] = {false, false};\n      if (e < e1) {\n        const int k = static_cast<int>(exc_index[e] & (kVector - 1));\n        const U u = bw ? unpack<U, S>(words, bw, k) : U(0);\n        const U ph = Num<F>::bits(\n            Num<F>::decode(static_cast<U>((b0 + u) * f), fr));\n        const bool in_col = vec * kVector + k < n_values;\n        x[0] = exc_bits[e];\n        x[1] = ph ^ (U(1) << (S - 1));\n        xok[0] = in_col && selected<Filter>(x[0], klo, khi);\n        xok[1] = in_col && selected<Filter>(ph, klo, khi);\n      }\n      acc.add(x, xok);\n    }\n  }\n  acc.finish(out);\n}\n\n'
# the first designs' shapes, which the kept kernels no longer name
_FIRST_SHAPES = ("constexpr int kThreads = alp::kAccThreads;\n"
                 "constexpr int kPer = alp::kAccPer;\n")
_K7_STREAM_ADD = "        acc.add(b, ok);\n      }\n    };\n"
_K7_FOLD = """        U fold = 0;
#pragma unroll
        for (int q = 0; q < kLaneStep; ++q) fold ^= ok[q] ? b[q] : U(0);
        if (fold == U(0x5bd1e995u)) out[Fixed<U>::W] = 1;
      }
    };
"""
_K7_EXC_ADD = "      acc.add(x, xok);\n"
_K7_EXC_FOLD = """      if (((xok[0] ? x[0] : U(0)) ^ (xok[1] ? x[1] : U(0))) ==
          U(0x5bd1e995u))
        out[Fixed<U>::W] = 1;
"""
_K7_CSR = """    const long long e0 = live ? exc_ptr[vec] : 0;
    const long long e1 = live ? exc_ptr[vec + 1] : 0;
"""
_K7_STREAM = "      alp::LaneStream<U> in(packed + ic * bw * L + ln, bw);\n"
_K7_FIELD = """          const U u = decltype(packed_words)::value ? in.next() : U(0);
"""
_K7_SLOT_UNPACK = """          const U u = decltype(packed_words)::value
                          ? unpack<U, S>(packed + ic * bw * L, bw,
                                         (s + q) * L + ln)
                          : U(0);
"""
# Acc::add (digits.cuh) as kept, and the first design's: the window
# computed twice a value, each digit negated in 64 bits, and a 64-bit select
# and add for each pair of a register window and a digit
_ACC_ADD = ("  // One thread's N values (K5/K6: kSumVals of a row; K7/K8: "
            "kLaneStep",
            "            atomic_add(&row[Fx::W + c - 1], k);\n        }\n"
            "      }\n    }\n  }\n\n")
_SELECT_ADD = "  // One thread's N values of a vector (kAccPer in K5-K8); ok[r] is false\n  // for values that are not summed (the pad).\n  template <int N>\n  __device__ __forceinline__ void add(const U (&b)[N], const bool (&ok)[N]) {\n    int lo = INT_MAX, hi = -1;\n#pragma unroll\n    for (int r = 0; r < N; ++r) {\n      const int j = ok[r] ? Fx::window(b[r]) : -1;\n      if (j >= 0) {\n        lo = min(lo, j);\n        hi = max(hi, j);\n      }\n    }\n    lo = __reduce_min_sync(kFullMask, lo);\n    hi = __reduce_max_sync(kFullMask, hi);\n    if (hi >= 0 && (base < 0 || lo < base || hi >= base + kAccR)) {\n      if (base >= 0) flush();\n      base = lo;\n    }\n    int special = 0;                         // a NaN or an Inf among them\n#pragma unroll\n    for (int r = 0; r < N; ++r) {\n      if (!ok[r]) continue;\n      const Fx x(b[r]);\n      special |= x.cls;\n      if (x.j < 0) continue;\n      long long sd[Fx::P];\n#pragma unroll\n      for (int p = 0; p < Fx::P; ++p)\n        sd[p] = x.neg ? -static_cast<long long>(x.d[p])\n                      : static_cast<long long>(x.d[p]);\n      const int rel = x.j - base;            // >= 0: base <= the warp's lo\n      if (rel >= kAccR) {                    // beyond the register range\n#pragma unroll\n        for (int p = 0; p < Fx::P; ++p)\n          if (sd[p]) atomic_add(&row[x.j + p], sd[p]);\n        continue;\n      }\n#pragma unroll\n      for (int w = 0; w < kRegs; ++w)\n#pragma unroll\n        for (int p = 0; p < Fx::P; ++p)\n          if (w - p >= 0 && w - p < kAccR)\n            reg[w] += rel == w - p ? sd[p] : 0;\n    }\n    // NaN and +-Inf are rare: where the warp holds one, each class is\n    // counted with a ballot a value and lane 0 adds the count into the\n    // shared row (no per-thread counters: registers, and an index\n    // cnt[cls - 1] the compiler cannot resolve would put the whole\n    // accumulator in local memory)\n    if (__any_sync(kFullMask, special)) {\n#pragma unroll\n      for (int r = 0; r < N; ++r) {\n        const int cls = ok[r] ? Fx(b[r]).cls : 0;\n#pragma unroll\n        for (int c = 1; c <= 3; ++c) {\n          const int k = __popc(__ballot_sync(kFullMask, cls == c));\n          if ((threadIdx.x & 31) == 0 && k)\n            atomic_add(&row[Fx::W + c - 1], k);\n        }\n      }\n    }\n  }\n\n"
# the add before it: each window's digit times the value's sign (+1 or -1)
# in 64 bits, the test beyond the register range made a value
_MULTIPLY_ADD = "  // One thread's N values (K5/K6: kAccPer of a vector; K7/K8: kLaneStep\n  // of a FastLanes lane, or an exception's true bits and its negated\n  // placeholder); ok[r] is false for values that are not summed (the pad).\n  // Each value's window is computed once.  A value in the warp's register\n  // range adds its P digits, placed by rel = j - Jw (a select a window),\n  // into all kRegs windows unconditionally, times its sign (+1 or -1): a\n  // zero, a NaN, an Inf or a value not summed has rel < 0 and adds 0.\n  template <int N>\n  __device__ __forceinline__ void add(const U (&b)[N], const bool (&ok)[N]) {\n    int j[N];\n    unsigned lo = UINT_MAX;                  // j = -1 is the largest unsigned\n    int hi = -1;\n    bool special = false;                    // a NaN or an Inf among them\n#pragma unroll\n    for (int r = 0; r < N; ++r) {\n      j[r] = ok[r] ? Fx::window(b[r]) : -1;\n      special |= ok[r] && Fx::special(b[r]);\n      lo = min(lo, static_cast<unsigned>(j[r]));\n      hi = max(hi, j[r]);\n    }\n    lo = __reduce_min_sync(kFullMask, lo);\n    hi = __reduce_max_sync(kFullMask, hi);\n    if (hi >= 0 && (base < 0 || static_cast<int>(lo) < base ||\n                    hi >= base + kAccR)) {\n      if (base >= 0) flush();\n      base = static_cast<int>(lo);\n    }\n#pragma unroll\n    for (int r = 0; r < N; ++r) {\n      uint32_t d[Fx::P];\n      Fx::digits(b[r], d);\n      const long long sgn = (b[r] >> (8 * sizeof(U) - 1)) ? -1 : 1;\n      const int rel = j[r] < 0 ? -1 : j[r] - base;   // base <= the warp's lo\n      if (rel >= kAccR) {                    // beyond the register range\n#pragma unroll\n        for (int p = 0; p < Fx::P; ++p)\n          if (d[p]) atomic_add(&row[j[r] + p], sgn * d[p]);\n      }\n#pragma unroll\n      for (int w = 0; w < kRegs; ++w) {\n        uint32_t dw = 0;\n#pragma unroll\n        for (int q = 0; q < kAccR; ++q)\n          if (w - q >= 0 && w - q < Fx::P) dw = rel == q ? d[w - q] : dw;\n        reg[w] += sgn * static_cast<long long>(dw);\n      }\n    }\n    // NaN and +-Inf are rare: where the warp holds one, each class is\n    // counted with a ballot a value and lane 0 adds the count into the\n    // shared row (no per-thread counters: registers, and an index\n    // cnt[cls - 1] the compiler cannot resolve would put the whole\n    // accumulator in local memory)\n    if (__any_sync(kFullMask, special)) {\n#pragma unroll\n      for (int r = 0; r < N; ++r) {\n        const int cls = ok[r] ? Fx(b[r]).cls : 0;\n#pragma unroll\n        for (int c = 1; c <= 3; ++c) {\n          const int k = __popc(__ballot_sync(kFullMask, cls == c));\n          if ((threadIdx.x & 31) == 0 && k)\n            atomic_add(&row[Fx::W + c - 1], k);\n        }\n      }\n    }\n  }\n\n"
# the add with the digit XORed with the sign mask and added by 64-bit adds
# with a carry in
_CARRY_ADD = "  // One thread's N values (K5/K6: kSumVals of a row; K7/K8: kLaneStep\n  // of a FastLanes lane, or an exception's true bits and its negated\n  // placeholder); ok[r] is false for values that are not summed (the pad).\n  // Each value's window is computed once.  A value in the warp's register\n  // range adds its P digits, placed by a select a window on j == Jw + q,\n  // into all kRegs windows unconditionally, with its sign: a digit d enters\n  // as the int64 whose high word is m and low word d ^ m, plus m & 1, with\n  // m all ones for a negative value (-d) and 0 else (d): a 64-bit add with\n  // a carry in and no multiply.  A window the value does\n  // not reach takes d = 0, and so does a zero, a NaN, an Inf or a value not\n  // summed (j = -1, never a window of the range once the warp holds a\n  // finite nonzero value; before that the adds are skipped).  Digits beyond\n  // the range take the shared row, behind a test that is the same for the\n  // warp.\n  template <int N>\n  __device__ __forceinline__ void add(const U (&b)[N], const bool (&ok)[N]) {\n    int j[N];\n    unsigned lo = UINT_MAX;                  // j = -1 is the largest unsigned\n    int hi = -1;\n    bool special = false;                    // a NaN or an Inf among them\n#pragma unroll\n    for (int r = 0; r < N; ++r) {\n      j[r] = ok[r] ? Fx::window(b[r]) : -1;\n      special |= ok[r] && Fx::special(b[r]);\n      lo = min(lo, static_cast<unsigned>(j[r]));\n      hi = max(hi, j[r]);\n    }\n    lo = __reduce_min_sync(kFullMask, lo);\n    hi = __reduce_max_sync(kFullMask, hi);\n    if (hi >= 0 && (base < 0 || static_cast<int>(lo) < base ||\n                    hi >= base + kAccR)) {\n      if (base >= 0) flush();\n      base = static_cast<int>(lo);\n    }\n    if (hi >= base + kAccR) {                // beyond the register range\n#pragma unroll\n      for (int r = 0; r < N; ++r)\n        if (j[r] >= base + kAccR) {\n          uint32_t d[Fx::P];\n          Fx::digits(b[r], d);\n          const long long sgn = (b[r] >> (8 * sizeof(U) - 1)) ? -1 : 1;\n#pragma unroll\n          for (int p = 0; p < Fx::P; ++p)\n            if (d[p]) atomic_add(&row[j[r] + p], sgn * d[p]);\n        }\n    }\n    if (hi >= 0) {                           // base >= 0 from here\n#pragma unroll\n      for (int r = 0; r < N; ++r) {\n        uint32_t d[Fx::P];\n        Fx::digits(b[r], d);\n        const uint32_t m = 0u - static_cast<uint32_t>(\n            b[r] >> (8 * sizeof(U) - 1));\n#pragma unroll\n        for (int w = 0; w < kRegs; ++w) {\n          uint32_t x = m;\n#pragma unroll\n          for (int q = 0; q < kAccR; ++q)\n            if (w - q >= 0 && w - q < Fx::P)\n              x = j[r] == base + q ? d[w - q] ^ m : x;\n          reg[w] += static_cast<long long>(\n                        (static_cast<unsigned long long>(m) << 32) | x) +\n                    (m & 1u);\n        }\n      }\n    }\n    // NaN and +-Inf are rare: where the warp holds one, each class is\n    // counted with a ballot a value and lane 0 adds the count into the\n    // shared row (no per-thread counters: registers, and an index\n    // cnt[cls - 1] the compiler cannot resolve would put the whole\n    // accumulator in local memory)\n    if (__any_sync(kFullMask, special)) {\n#pragma unroll\n      for (int r = 0; r < N; ++r) {\n        const int cls = ok[r] ? Fx(b[r]).cls : 0;\n#pragma unroll\n        for (int c = 1; c <= 3; ++c) {\n          const int k = __popc(__ballot_sync(kFullMask, cls == c));\n          if ((threadIdx.x & 31) == 0 && k)\n            atomic_add(&row[Fx::W + c - 1], k);\n        }\n      }\n    }\n  }\n\n"
# the add with the sign as the multipliers of two 32-bit multiply-adds
_FMA_ADD = "  // One thread's N values (K5/K6: kSumVals of a row; K7/K8: kLaneStep\n  // of a FastLanes lane, or an exception's true bits and its negated\n  // placeholder); ok[r] is false for values that are not summed (the pad).\n  // Each value's window is computed once.  A value in the warp's register\n  // range adds its P digits, placed by a select a window on j == Jw + q,\n  // into all kRegs windows unconditionally, with its sign: a digit d enters\n  // as d * sl widened to 64 bits plus d * sh in the high word, with\n  // (sl, sh) = (1, 0) for a positive value and (2^32 - 1, 2^32 - 1) for a\n  // negative one (-d modulo 2^64): two multiply-adds, on the multiply-add\n  // pipe beside the selects and shifts.  A window the value does\n  // not reach takes d = 0, and so does a zero, a NaN, an Inf or a value not\n  // summed (j = -1, never a window of the range once the warp holds a\n  // finite nonzero value; before that the adds are skipped).  Digits beyond\n  // the range take the shared row, behind a test that is the same for the\n  // warp.\n  template <int N>\n  __device__ __forceinline__ void add(const U (&b)[N], const bool (&ok)[N]) {\n    int j[N];\n    unsigned lo = UINT_MAX;                  // j = -1 is the largest unsigned\n    int hi = -1;\n    bool special = false;                    // a NaN or an Inf among them\n#pragma unroll\n    for (int r = 0; r < N; ++r) {\n      j[r] = ok[r] ? Fx::window(b[r]) : -1;\n      special |= ok[r] && Fx::special(b[r]);\n      lo = min(lo, static_cast<unsigned>(j[r]));\n      hi = max(hi, j[r]);\n    }\n    lo = __reduce_min_sync(kFullMask, lo);\n    hi = __reduce_max_sync(kFullMask, hi);\n    if (hi >= 0 && (base < 0 || static_cast<int>(lo) < base ||\n                    hi >= base + kAccR)) {\n      if (base >= 0) flush();\n      base = static_cast<int>(lo);\n    }\n    if (hi >= base + kAccR) {                // beyond the register range\n#pragma unroll\n      for (int r = 0; r < N; ++r)\n        if (j[r] >= base + kAccR) {\n          uint32_t d[Fx::P];\n          Fx::digits(b[r], d);\n          const long long sgn = (b[r] >> (8 * sizeof(U) - 1)) ? -1 : 1;\n#pragma unroll\n          for (int p = 0; p < Fx::P; ++p)\n            if (d[p]) atomic_add(&row[j[r] + p], sgn * d[p]);\n        }\n    }\n    if (hi >= 0) {                           // base >= 0 from here\n#pragma unroll\n      for (int r = 0; r < N; ++r) {\n        uint32_t d[Fx::P];\n        Fx::digits(b[r], d);\n        const uint32_t sh = 0u - static_cast<uint32_t>(\n            b[r] >> (8 * sizeof(U) - 1));\n        const uint32_t sl = sh | 1u;\n#pragma unroll\n        for (int w = 0; w < kRegs; ++w) {\n          uint32_t dw = 0;\n#pragma unroll\n          for (int q = 0; q < kAccR; ++q)\n            if (w - q >= 0 && w - q < Fx::P)\n              dw = j[r] == base + q ? d[w - q] : dw;\n          unsigned long long a = static_cast<unsigned long long>(reg[w]);\n          a += static_cast<unsigned long long>(dw) * sl;\n          a += static_cast<unsigned long long>(dw * sh) << 32;\n          reg[w] = static_cast<long long>(a);\n        }\n      }\n    }\n    // NaN and +-Inf are rare: where the warp holds one, each class is\n    // counted with a ballot a value and lane 0 adds the count into the\n    // shared row (no per-thread counters: registers, and an index\n    // cnt[cls - 1] the compiler cannot resolve would put the whole\n    // accumulator in local memory)\n    if (__any_sync(kFullMask, special)) {\n#pragma unroll\n      for (int r = 0; r < N; ++r) {\n        const int cls = ok[r] ? Fx(b[r]).cls : 0;\n#pragma unroll\n        for (int c = 1; c <= 3; ++c) {\n          const int k = __popc(__ballot_sync(kFullMask, cls == c));\n          if ((threadIdx.x & 31) == 0 && k)\n            atomic_add(&row[Fx::W + c - 1], k);\n        }\n      }\n    }\n  }\n\n"
_K11_KERNEL = ("template <typename F>\n__global__ void __launch_bounds__(kBlock)"
               "\nscore_kernel(",
               "  return static_cast<int>(cudaGetLastError());\n}\n")
# the first design: one warp a task, one sample a lane, a 64-bit task / C,
# min, max and count by shuffles and a ballot
_K11_WARP_TASK = 'constexpr int kThreads = 256;\n\ntemplate <typename F>\n__global__ void __launch_bounds__(kThreads)\nscore_kernel(const typename alp::Alp<F>::U* __restrict__ samples,\n             const int* __restrict__ ef, int ef_per_segment, int n_cand,\n             const int* __restrict__ k_count, long long n_tasks,\n             typename alp::Alp<F>::Tables t, int exc_bits,\n             int* __restrict__ est, int* __restrict__ non_exc) {\n  using A = alp::Alp<F>;\n  using I = typename A::I;\n  const long long task =\n      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;\n  const int lane = threadIdx.x % 32;\n  if (task >= n_tasks) return;               // whole warps leave together\n  const long long seg = task / n_cand;\n  const int c = static_cast<int>(task % n_cand);\n  if (k_count && c >= k_count[seg]) {\n    if (lane == 0) est[task] = non_exc[task] = 0;\n    return;\n  }\n  const int* pair = ef + 2 * ((ef_per_segment ? seg * n_cand : 0) + c);\n  const typename A::Pair p = A::pair_of(t, pair[0], pair[1]);\n  const alp::Encoded<I> enc =\n      A::search(samples[seg * kSamples + lane], p, t);\n  I mx = enc.exc ? A::kMin : enc.n;\n  I mn = enc.exc ? A::kMax : enc.n;\n  for (int o = 16; o > 0; o >>= 1) {\n    mx = max(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));\n    mn = min(mn, __shfl_xor_sync(0xFFFFFFFFu, mn, o));\n  }\n  const int ne = __popc(__ballot_sync(0xFFFFFFFFu, !enc.exc));\n  if (lane == 0) {\n    est[task] = kSamples * A::width(mx, mn) + (kSamples - ne) * exc_bits;\n    non_exc[task] = ne;\n  }\n}\n\ntemplate <typename F>\nint launch(const void* samples, const void* ef, int ef_per_segment,\n           int n_cand, const void* k_count, long long n,\n           const typename alp::Alp<F>::Tables& t, int exc_bits, void* est,\n           void* non_exc, void* stream) {\n  const long long tasks = n * n_cand;\n  const long long blocks = (tasks * 32 + kThreads - 1) / kThreads;\n  if (n < 0 || n_cand < 1 || blocks > INT_MAX)\n    return static_cast<int>(cudaErrorInvalidValue);\n  if (tasks)\n    score_kernel<F><<<static_cast<unsigned>(blocks), kThreads, 0,\n                      static_cast<cudaStream_t>(stream)>>>(\n        static_cast<const typename alp::Alp<F>::U*>(samples),\n        static_cast<const int*>(ef), ef_per_segment, n_cand,\n        static_cast<const int*>(k_count), tasks, t, exc_bits,\n        static_cast<int*>(est), static_cast<int*>(non_exc));\n  return static_cast<int>(cudaGetLastError());\n}\n\n'
_K11_LOOP = "    for (int i = 0; i < kSamples; ++i) {\n"
_STAGE = """    __syncthreads();                         // the last vector is read
    alp::stage<U, S>(words, packed + i * bw * (kVector / S), bw);
    __syncthreads();
"""
_DIRECT = "    const U* words = packed + i * bw * (kVector / S);\n"
_REDUCE = """  for (int o = 16; o > 0; o >>= 1) {
    mx = max(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
    mn = min(mn, __shfl_xor_sync(0xFFFFFFFFu, mn, o));
  }
  const int ne = __popc(__ballot_sync(0xFFFFFFFFu, !enc.exc));
"""
_INDEX = """  const long long seg = task / n_cand;
  const int c = static_cast<int>(task % n_cand);
"""
_INDEX32 = """  const int t32 = static_cast<int>(task);
  const long long seg = t32 / n_cand;
  const int c = t32 % n_cand;
"""


# K3/K4 (falp.cu) and K5/K6 (exact_sum.cu): each kernel and its launch as
# regions of the sources, and the first designs that replace them: K4 a
# block a vector, both parts staged in shared memory behind a barrier, two
# unpack() calls a value; K6 a block a row, 4 scalar loads a thread at
# k = tid + 256 r and a pad test a value
_K4_KERNEL = ("// K3 / K4: ALP_RD glue", "// The reference's truncating f64-bits")
_K4_END = "// The reference's truncating f64-bits"
_K4_LAUNCH = ("template <typename U, int S>\nstatic int launch_rd(",
              "  return static_cast<int>(cudaGetLastError());\n}\n")
_K4_STAGED = '// K3 / K4: ALP_RD glue, one block per vector.  Indexes past the\n// dictionary (exceptions) are clamped to its last entry, as the host\n// decode does; the exception scatter overwrites them afterwards.\ntemplate <typename U, int S>\n__global__ void __launch_bounds__(kThreads)\nrd_kernel(const U* __restrict__ right, int rbw,\n          const uint16_t* __restrict__ left, int lbw,\n          const uint16_t* __restrict__ dict,\n          const int* __restrict__ dict_size,\n          const long long* __restrict__ rows, U* __restrict__ out) {\n  __shared__ U rwords[kVector];\n  __shared__ uint16_t lwords[kVector];       // lbw <= 16: at most 1024\n  __shared__ U entries[8];\n  const long long vec = blockIdx.x;\n  stage<U, S>(rwords, right + vec * rbw * (kVector / S), rbw);\n  stage<uint16_t, 16>(lwords, left + vec * lbw * (kVector / 16), lbw);\n  if (threadIdx.x < 8) entries[threadIdx.x] = dict[vec * 8 + threadIdx.x];\n  __syncthreads();\n  const int last = max(min(dict_size[vec], 8) - 1, 0);\n  U* dst = out + (rows ? rows[vec] : vec) * kVector;\n  for (int k = threadIdx.x; k < kVector; k += kThreads) {\n    const U r = rbw ? unpack<U, S>(rwords, rbw, k) : U(0);\n    const int idx = lbw ? unpack<uint16_t, 16>(lwords, lbw, k) : 0;\n    const U l = entries[min(idx, last)];\n    dst[k] = rbw < S ? static_cast<U>(static_cast<U>(l << rbw) | r) : r;\n  }\n}\n\n'
_K4_STAGED_LAUNCH = 'template <typename U, int S>\nstatic int launch_rd(const void* right, int rbw, const void* left, int lbw,\n                     const void* dict, const void* dict_size,\n                     const void* rows, void* out, long long n,\n                     void* stream) {\n  if (n < 0 || n > INT_MAX || rbw < 0 || rbw > S || lbw < 0 || lbw > 16)\n    return static_cast<int>(cudaErrorInvalidValue);\n  if (n > 0)\n    rd_kernel<U, S><<<static_cast<unsigned>(n), kThreads, 0,\n                      static_cast<cudaStream_t>(stream)>>>(\n        static_cast<const U*>(right), rbw,\n        static_cast<const uint16_t*>(left), lbw,\n        static_cast<const uint16_t*>(dict),\n        static_cast<const int*>(dict_size),\n        static_cast<const long long*>(rows), static_cast<U*>(out));\n  return static_cast<int>(cudaGetLastError());\n}\n'
_K4_INDEX = "    const int idx = lbw ? unpack<uint16_t, 16>(lwords, lbw, k) : 0;\n"
_K4_RIGHT = "    const U r = rbw ? unpack<U, S>(rwords, rbw, k) : U(0);\n"
_K4_STAGE = """  __shared__ U rwords[kVector];
  __shared__ uint16_t lwords[kVector];       // lbw <= 16: at most 1024
  __shared__ U entries[8];
  const long long vec = blockIdx.x;
  stage<U, S>(rwords, right + vec * rbw * (kVector / S), rbw);
  stage<uint16_t, 16>(lwords, left + vec * lbw * (kVector / 16), lbw);
  if (threadIdx.x < 8) entries[threadIdx.x] = dict[vec * 8 + threadIdx.x];
  __syncthreads();
"""
_K4_DIRECT = """  const long long vec = blockIdx.x;
  const U* rwords = right + vec * rbw * (kVector / S);
  const uint16_t* lwords = left + vec * lbw * (kVector / 16);
  const uint16_t* entries = dict + vec * 8;
"""
# the kept K4's dictionary in shared memory and its lookup, and the same in
# registers (four words of two u16, an entry picked by two byte permutes and
# a select)
_K4_DICT = """  if (lane < 8) mine[lane] = dict[vec * 8 + lane];
  __syncwarp(kLanes << ((threadIdx.x & 31) / L * L));   // the vector's lanes
"""
_K4_REGISTER_DICT = """  uint32_t e[4];
  const uint16_t* d = dict + vec * 8;
  if ((reinterpret_cast<uintptr_t>(dict) & 15u) == 0) {   // uniform
    const uint4 w = *reinterpret_cast<const uint4*>(d);
    e[0] = w.x;
    e[1] = w.y;
    e[2] = w.z;
    e[3] = w.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      e[q] = d[2 * q] | static_cast<uint32_t>(d[2 * q + 1]) << 16;
  }
"""
_K4_LOOKUP = """      const U l = mine[min(static_cast<uint32_t>(ls[q % Q].next()), last)];
"""
_K4_REGISTER_LOOKUP = """      const uint32_t c = min(static_cast<uint32_t>(ls[q % Q].next()), last);
      const uint32_t sel = (c & 3u) * 0x22u + 0x10u;
      const U l = (c & 4u ? __byte_perm(e[2], e[3], sel)
                          : __byte_perm(e[0], e[1], sel)) & 0xFFFFu;
"""
# the kept K5/K6's 16-byte load and its add
_K6_LOAD = """      load16(bits + ic * kVector + V * (t + q * P), &b[q * V]);
"""
_K6_SCALAR_LOAD = """#pragma unroll
      for (int c = 0; c < V; ++c)
        b[q * V + c] = bits[ic * kVector + V * (t + q * P) + c];
"""
_K6_ADD = "    acc.add(b, ok);\n  }\n  acc.finish(out);\n"
_K6_KERNEL = ("// K5 / K6: rows of decoded", "// K7 / K8: the falp decode")
_K6_END = "// K7 / K8: the falp decode"
_K6_LAUNCH = ("template <typename U, bool Filter>\nint launch_exact_sum(",
              "  return static_cast<int>(cudaGetLastError());\n}\n")
_K6_FIRST = '// K5 / K6: rows of decoded bit patterns, row i of vector vec[i].\ntemplate <typename U, bool Filter>\n__global__ void __launch_bounds__(kThreads)\nexact_sum_kernel(const U* __restrict__ bits,\n                 const long long* __restrict__ vec, long long n,\n                 long long n_values, U klo, U khi,\n                 long long* __restrict__ out) {\n  __shared__ long long row[Fixed<U>::W + 3];\n  zero_row<U>(row);\n  Acc<U> acc(row);\n  for (long long i = blockIdx.x; i < n; i += gridDim.x) {\n    const long long first = vec[i] * kVector;\n    U b[kPer];\n    bool ok[kPer];\n#pragma unroll\n    for (int r = 0; r < kPer; ++r) {\n      const int k = threadIdx.x + r * kThreads;\n      b[r] = bits[i * kVector + k];\n      ok[r] = first + k < n_values && selected<Filter>(b[r], klo, khi);\n    }\n    acc.add(b, ok);\n  }\n  acc.finish(out);\n}\n\n'
_K6_FIRST_LAUNCH = 'template <typename U, bool Filter>\nint launch_exact_sum(const void* bits, const void* vec, long long n,\n                     long long n_values, U klo, U khi, void* out, int dev,\n                     void* stream) {\n  if (bad_size(n, n_values)) return static_cast<int>(cudaErrorInvalidValue);\n  unsigned blocks = 0;\n  const cudaError_t err =\n      grid_for(exact_sum_kernel<U, Filter>, n, dev, kThreads, 0, &blocks);\n  if (err != cudaSuccess) return static_cast<int>(err);\n  if (blocks)\n    exact_sum_kernel<U, Filter><<<blocks, kThreads, 0,\n                                  static_cast<cudaStream_t>(stream)>>>(\n        static_cast<const U*>(bits), static_cast<const long long*>(vec), n,\n        n_values, klo, khi, static_cast<long long*>(out));\n  return static_cast<int>(cudaGetLastError());\n}\n'
_K6_FIRST_ADD = "    acc.add(b, ok);\n  }\n  acc.finish(out);\n"
_K6_FIRST_OK = """#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int k = threadIdx.x + r * kThreads;
      b[r] = bits[i * kVector + k];
      ok[r] = first + k < n_values && selected<Filter>(b[r], klo, khi);
    }
"""
# the decoded bits XOR-folded into one output: the loads and the pad test
# stay, the digits go
_FOLD = """    U fold = 0;
#pragma unroll
    for (int r = 0; r < %s; ++r) fold ^= ok[r] ? b[r] : U(0);
    if (fold == U(0x5bd1e995u)) out[Fixed<U>::W] = 1;
  }
  acc.finish(out);
"""



def _k4_first(kernel: str = _K4_STAGED) -> dict:
    """The edits that put K4's first design (or a split of it) and its
    launch in place of the kept kernel's."""
    return {"falp.cu": [(_K4_KERNEL, kernel + _K4_END),
                        (_K4_LAUNCH, _K4_STAGED_LAUNCH)]}


def _k6_first(kernel: str = _K6_FIRST) -> dict:
    """The same for K6's first loop (or a split of it)."""
    return {"exact_sum.cu": [(_K6_KERNEL, _FIRST_SHAPES + kernel + _K6_END),
                             (_K6_LAUNCH, _K6_FIRST_LAUNCH)]}


# name -> (exact, {source file: [(old, new), ...]})
VARIANTS = {
    # K3/K4's first design (exact) and its splits, measured before the
    # redesign: no second unpack (index 0; wrong outputs), the right part
    # read as whole words (no field extraction; wrong outputs), the words
    # read straight from device memory (no staging, no barrier; exact)
    "k4_staged": (True, _k4_first()),
    "k4_no_index": (False, _k4_first(_K4_STAGED.replace(
        _K4_INDEX, "    const int idx = 0;\n"))),
    "k4_no_unpack": (False, _k4_first(_K4_STAGED.replace(
        _K4_RIGHT, "    const U r = rbw ? rwords[k % (kVector / S) + (kVector "
                   "/ S) * (k / (kVector / S) * rbw / S)] : U(0);\n"))),
    "k4_no_stage": (True, _k4_first(_K4_STAGED.replace(_K4_STAGE,
                                                       _K4_DIRECT))),
    # the kept K4 (and K3 through it): the dictionary in registers (exact),
    # K3 on K4's lane streams (exact); the index streams removed (index 0)
    # and the right stream removed (wrong outputs); the sweeps of the step
    # and of the block (exact)
    "k4_register_dict": (True, {"falp.cu": [
        (_K4_DICT, _K4_REGISTER_DICT), (_K4_LOOKUP, _K4_REGISTER_LOOKUP)]}),
    "k4_stream_f64": (True, {"falp.cu": [("  if constexpr (S == 64) {",
                                          "  if constexpr (S == 0) {")]}),
    "k4_kept_no_index": (False, {"falp.cu": [(_K4_LOOKUP, _K4_LOOKUP.replace(
        "ls[q % Q].next()", "0u"))]}),
    "k4_kept_no_right": (False, {"falp.cu": [(
        "      const U r = rs.next();\n", "      const U r = U(0);\n")]}),
    "k4_step_8": (True, {"falp.cu": [("constexpr int kRdStep = 4;",
                                      "constexpr int kRdStep = 8;")]}),
    "k4_block_128": (True, {"falp.cu": [("constexpr int kRdThreads = 256;",
                                         "constexpr int kRdThreads = 128;")]}),
    "k4_block_512": (True, {"falp.cu": [("constexpr int kRdThreads = 256;",
                                         "constexpr int kRdThreads = 512;")]}),
    # the kept K5/K6: scalar loads of the same values (exact), 4 or 16
    # values an add() (exact), blocks of 256 or 512 (exact), the three adds
    # weighed against the present one (exact; they change K5-K8 and K18),
    # and the digits removed (wrong outputs)
    "k6_scalar_loads": (True, {"exact_sum.cu": [(_K6_LOAD, _K6_SCALAR_LOAD)]}),
    "k6_four_per_add": (True, {"exact_sum.cu": [(
        "constexpr int kSumVals = 8;", "constexpr int kSumVals = 4;")]}),
    "k6_vals_16": (True, {"exact_sum.cu": [(
        "constexpr int kSumVals = 8;", "constexpr int kSumVals = 16;")]}),
    "k6_block_256": (True, {"exact_sum.cu": [(
        "constexpr int kSumThreads = 1024;",
        "constexpr int kSumThreads = 256;")]}),
    "k6_block_512": (True, {"exact_sum.cu": [(
        "constexpr int kSumThreads = 1024;",
        "constexpr int kSumThreads = 512;")]}),
    "k6_multiply_add": (True, {"digits.cuh": [(_ACC_ADD, _MULTIPLY_ADD)]}),
    "k6_carry_add": (True, {"digits.cuh": [(_ACC_ADD, _CARRY_ADD)]}),
    "k6_fma_add": (True, {"digits.cuh": [(_ACC_ADD, _FMA_ADD)]}),
    "k6_kept_no_digits": (False, {"exact_sum.cu": [(_K6_ADD,
                                                    _FOLD % "kSumVals")]}),
    # K5/K6's first loop (exact) and its splits: the digits removed (the
    # bits XOR-folded into one output), the pad test once a row (exact)
    "k6_first_loop": (True, _k6_first()),
    "k6_no_digits": (False, _k6_first(_K6_FIRST.replace(
        _K6_FIRST_ADD, _FOLD % "kPer"))),
    "k6_one_row_check": (True, _k6_first(_K6_FIRST.replace(_K6_FIRST_OK, """\
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      b[r] = bits[i * kVector + threadIdx.x + r * kThreads];
    if (first + kVector <= n_values) {       // block-uniform: a whole row
#pragma unroll
      for (int r = 0; r < kPer; ++r) ok[r] = selected<Filter>(b[r], klo, khi);
    } else {
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        ok[r] = first + threadIdx.x + r * kThreads < n_values &&
                selected<Filter>(b[r], klo, khi);
    }
"""))),
    # the parts of K17, each removed in turn (the outputs are wrong)
    "k17_no_brackets": (False, {"keys.cu": [(_BRACKETS, "    if (false) {")]}),
    "k17_no_search": (False, {"keys.cu": [(_SEARCH, """#pragma unroll
  for (int j = 0; j < N; ++j)
    p[j] = static_cast<int>(key[j] & (t.tree.L >= 10 ? 1023 : 0));""")]}),
    "k17_no_bins": (False, {"keys.cu": [(_BINS, "    if (p[j] == -7) "
                                                "count_bin(real[j], p[j], "
                                                "t.hist);")]}),
    # more blocks an SM at fewer registers (spills)
    "k17_5_blocks": (True, {"keys.cu": [(_BOUNDS, _BOUNDS.replace(
        "(kThreads)", "(kThreads, 5)"))]}),
    "k17_6_blocks": (True, {"keys.cu": [(_BOUNDS, _BOUNDS.replace(
        "(kThreads)", "(kThreads, 6)"))]}),
    # a thread's keys one or two at a time instead of four in lockstep
    "k17_1_key": (True, {"keys.cu": [(_RANK_CALL, """#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const U k1[1] = {key[j]};
      const bool r1[1] = {real[j]};
      rank_keys(k1, r1, tab);
    }
""")]}),
    "k17_2_keys": (True, {"keys.cu": [(_RANK_CALL, """#pragma unroll
    for (int j = 0; j < kPer; j += 2) {
      const U k2[2] = {key[j], key[j + 1]};
      const bool r2[2] = {real[j], real[j + 1]};
      rank_keys(k2, r2, tab);
    }
""")]}),
    # an f64 node in two 32-bit halves: the low one read only on a tie
    "k17_split_f64": (True, {"keys.cu": [
        (_TREE_BUILD, """      const U v = s < n ? thr[s] : static_cast<U>(~U(0));
      if (sizeof(U) == 8) {
        auto* h = reinterpret_cast<uint32_t*>(w);
        h[at] = static_cast<uint32_t>(static_cast<uint64_t>(v) >> 32);
        h[(1 << L) + at] = static_cast<uint32_t>(v);
      } else {
        w[at] = v;
      }"""),
        (_TREE_LOOP, """    if (sizeof(U) == 8) {
      const auto* hi = reinterpret_cast<const uint32_t*>(node);
      const uint32_t* lo = hi + (1 << L);
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const uint32_t kh = static_cast<uint32_t>(
              static_cast<uint64_t>(key[j]) >> 32);
          const uint32_t h = hi[at[j]];
          bool below = h < kh;
          if (h == kh) below = lo[at[j]] < static_cast<uint32_t>(key[j]);
          at[j] = 2 * at[j] + below;
        }
      }
    } else {
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int j = 0; j < N; ++j)
          at[j] = 2 * at[j] + (node[at[j]] < key[j]);
      }
    }""")]}),
    # one vote for a thread's keys before the bracket slots
    "k17_one_vote": (True, {"keys.cu": [("""#pragma unroll
  for (int j = 0; j < N; ++j) bracket_key(key[j], m[j], t.wlo, t.whi);
}""", """  bool more = false;
  const volatile U* vlo = t.wlo;
  const volatile U* vhi = t.whi;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (m[j]) {
      const int b = __ffs(m[j]) - 1;
      more |= (m[j] & (m[j] - 1)) != 0 || key[j] < vlo[b] || key[j] > vhi[b];
    }
  if (__any_sync(kFull, more)) {
#pragma unroll
    for (int j = 0; j < N; ++j) bracket_key(key[j], m[j], t.wlo, t.whi);
  }
}""")]}),
    # the row loop with its rows staged two ahead (three buffers)
    "keys_stage_2_ahead": (True, {"vector.cuh": [
        ("  unsigned xval;\n", "  unsigned xval, buf2;\n"),
        ("""      stage_layout(round16(l.xval + 2 * kVector * key_bytes), staged);
  return l;""", """      stage_layout(round16(l.xval + 2 * kVector * key_bytes), staged);
  l.buf2 = l.bytes;
  l.bytes = round16(l.buf2 + staged);
  return l;"""),
        ("""  if (blockIdx.x < n) src.stage_async(dyn + lay.buf[0], blockIdx.x);
  commit_async();""", """  if (blockIdx.x < n) src.stage_async(dyn + lay.buf[0], blockIdx.x);
  commit_async();
  if (blockIdx.x + gridDim.x < n)
    src.stage_async(dyn + lay.buf[1], blockIdx.x + gridDim.x);
  commit_async();"""),
        ("""    wait_async();
    __syncthreads();                         // row i staged and marked
    const unsigned char* buf = it & 1 ? buf1 : buf0;
    if (nxt < n) src.stage_async(it & 1 ? buf0 : buf1, nxt);
    commit_async();""", """    asm volatile("cp.async.wait_group 1;\\n" ::: "memory");
    __syncthreads();                         // row i staged and marked
    const unsigned bufs[3] = {lay.buf[0], lay.buf[1], lay.buf2};
    const unsigned char* buf = dyn + bufs[it % 3];
    if (nxt + gridDim.x < n)
      src.stage_async(dyn + bufs[(it + 2) % 3], nxt + gridDim.x);
    commit_async();""")]}),
    # the row loop without its exceptions (no marks, no payloads, no
    # patch): wrong where a vector holds one
    "keys_no_exceptions": (False, {"vector.cuh": [
        (_PATCH, ""), (_STORE_FIRST, ""), (_STORE_NEXT, "")]}),
    # the row loop without the decode: a payload slot's word a value
    "keys_no_decode": (False, {"vector.cuh": [(_VALUE, """      U b = static_cast<U>(k) ^ xv[k];
""")]}),
    # K15's few-threshold path forced onto the search tree
    "k15_tree": (True, {"keys.cu": [(_SMALL, _SMALL.replace("kSmall", "0"))]}),
    # K15's few-threshold path at up to 16 thresholds (padded to 16)
    "k15_small_16": (True, {"keys.cu": [(_K_SMALL, _K_SMALL.replace(
        "2;", "16;"))]}),
    # K15's few-threshold path without its counts: the row loop alone, the
    # keys folded into one count so that the decode stays
    "k15_no_bins": (False, {"keys.cu": [(_COUNT_SMALL, """  U k = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) k ^= real[j] ? key[j] : U(0);
  above[0] += static_cast<unsigned>(k) & 1u;""")]}),
    # K16 merged by warp 0, which takes the last row's pairs (slots of two
    # parities) after the next row's barrier: no second barrier a vector
    "k16_warp_merge": (True, {"keys.cu": [
        (_K16_SLOTS, """  __shared__ U wlo[2][kKeyWarps], whi[2][kKeyWarps];
  __shared__ long long wvec[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int it = 0;
  const auto merge = [&](int s) {
    U lo = lane < kKeyWarps ? wlo[s][lane] : static_cast<U>(~U(0));
    U hi = lane < kKeyWarps ? whi[s][lane] : U(0);
    warp_extremes(lo, hi);
    if (lane < 2) out[2 * wvec[s] + lane] = lane ? hi : lo;
  };
"""),
        (_K16_MERGE, """    if (lane == 0) {
      wlo[it & 1][warp] = lo;
      whi[it & 1][warp] = hi;
      if (warp == 0) wvec[it & 1] = vec;
    }
    if (warp == 0 && it > 0) merge((it - 1) & 1);
    ++it;
  });
  __syncthreads();
  if (warp == 0 && it > 0) merge((it - 1) & 1);
}""")]}),
    # K18 with the first design's settle (64-bit shared atomics of each
    # warp's windows into the parity's row) on the row loop
    "k18_atomic_settle": (True, {"group.cu": [(_K18_STORE, """    acc.settle();
    if (lane == 0) s.base[warp] = -1;
""")]}),
    # K18 without its digit sums, and without its key extremes
    "k18_no_digits": (False, {"group.cu": [("    acc.add(b, real);\n", "")]}),
    "k18_no_keys": (False, {"group.cu": [
        (_K18_KEYS, ""), ("    warp_extremes(lo, hi);\n", "")]}),
    # K18 in blocks of 256 threads, 4 values a thread
    "k18_256_threads": (True, {"group.cu": [(
        "constexpr int kSumThreads = 128;",
        "constexpr int kSumThreads = 256;")]}),
    # K20's first design: unpack() of every slot from the packed words
    "k20_slot_unpack": (True, {"falp.cu": [(_K20_STREAM, """\
    const uint64_t* words = packed + vec * bw * kLanes64;
    for (int s = 0; s < kSlots64; ++s)
      acc = __fadd_rn(acc, cut(unpack<uint64_t, 64>(words, bw,
                                                    s * kLanes64 + lane)));
""")]}),
    # K20 word by word, one field at a time: the fields that start in the
    # current word, then one rotation of the words
    "k20_word_loop": (True, {"falp.cu": [(_K20_STREAM, """\
    const uint64_t* lanep = packed + vec * bw * kLanes64 + lane;
    const uint64_t mask = bw >= 64 ? ~0ull : (1ull << bw) - 1;
    uint64_t cur = lanep[0];
    uint64_t nxt = bw > 1 ? lanep[kLanes64] : 0;
    uint64_t ahead = bw > 2 ? lanep[2 * kLanes64] : 0;
    int s = 0, off = 0;
    for (int w = 0; s < kSlots64; ++w) {
      for (; s < kSlots64 && off < 64; ++s, off += bw)
        acc = __fadd_rn(acc, cut(alp::funnel_r(cur, nxt, off) & mask));
      off -= 64;
      cur = nxt;
      nxt = ahead;
      ahead = w + 3 < bw ? lanep[(w + 3) * kLanes64] : 0;
    }
""")]}),
    # K20 with each field's one or two words loaded where it is taken (L1
    # hits after the first), in steps of 4
    "k20_direct": (True, {"falp.cu": [(_K20_STREAM, """\
    const uint64_t* lanep = packed + vec * bw * kLanes64 + lane;
    const uint64_t mask = bw >= 64 ? ~0ull : (1ull << bw) - 1;
    for (int s = 0; s < kSlots64; s += kSumStep) {
      float t[kSumStep];
#pragma unroll
      for (int q = 0; q < kSumStep; ++q) {
        const int off = (s + q) * bw, w0 = off >> 6, s0 = off & 63;
        t[q] = cut(alp::funnel_r(lanep[w0 * kLanes64],
                                 s0 + bw > 64 ? lanep[(w0 + 1) * kLanes64]
                                              : 0ull,
                                 s0) & mask);
      }
#pragma unroll
      for (int q = 0; q < kSumStep; ++q) acc = __fadd_rn(acc, t[q]);
    }
""")]}),
    # K20's int64 -> double by the 2^52 magic add where |m| < 2^51 (exact
    # there), the convert elsewhere
    "k20_magic_convert": (True, {"falp.cu": [(_K20_DECODE, """\
    const long long m = static_cast<long long>((b + u) * f);
    return trunc_f32(Num<double>::bits(__dmul_rn(
        static_cast<unsigned long long>(m + (1ll << 51)) < (1ull << 52)
            ? __dsub_rn(__longlong_as_double(m + 0x4338000000000000ll),
                        6755399441055744.0)
            : __ll2double_rn(m),
        fr)));
""")]}),
    # K20 without the int64 -> double convert (the integer's bits taken as
    # a double)
    "k20_no_convert": (False, {"falp.cu": [(_K20_DECODE, """\
    return trunc_f32(Num<double>::bits(__dmul_rn(
        __longlong_as_double(static_cast<long long>((b + u) * f)), fr)));
""")]}),
    # K19 without its path for a warp of one group
    "k19_no_warp_path": (True, {"group.cu": [(_WARP_PATH, _WARP_PATH.replace(
        "real && g == g0)", "real && g == g0) && g0 < 0"))]}),
    # K7: the first design's parts over the kept ones (exact)
    "k7_staged": (True, {"exact_sum.cu": [(_K7_KERNEL,
                                           _FIRST_SHAPES + _K7_STAGED),
                                          (_K7_ROWS, _K7_ROWS.replace(
                                              "kLaneThreads / 32 * "
                                              "lane_rows<F>()", "1"))]}),
    "k7_shared_exceptions": (True, {"exact_sum.cu": [
        (_K7_KERNEL, _FIRST_SHAPES + _K7_SHARED_EXCEPTIONS),
        (_K7_ROWS, _K7_ROWS.replace("kLaneThreads / 32 * lane_rows<F>()",
                                    "1"))]}),
    "k7_select_digits": (True, {"digits.cuh": [(_ACC_ADD, _SELECT_ADD)]}),
    # K7's lanes through unpack() of every slot instead of the stream
    "k7_slot_unpack": (True, {"exact_sum.cu": [(_K7_STREAM, ""),
                                               (_K7_FIELD, _K7_SLOT_UNPACK)]}),
    # K7's parts removed (the outputs are wrong): the digit sums (the
    # decoded bits XOR-folded into one output, so that the decode stays),
    # the exception path
    "k7_no_digits": (False, {"exact_sum.cu": [(_K7_STREAM_ADD, _K7_FOLD),
                                              (_K7_EXC_ADD, _K7_EXC_FOLD)]}),
    "k7_no_exceptions": (False, {"exact_sum.cu": [(_K7_CSR, """\
    const long long e0 = 0, e1 = 0;
""")]}),
    # K7's sweeps: values an add(), threads a block
    "k7_step_2": (True, {"exact_sum.cu": [(
        "constexpr int kLaneStep = 4;", "constexpr int kLaneStep = 2;")]}),
    "k7_step_8": (True, {"exact_sum.cu": [(
        "constexpr int kLaneStep = 4;", "constexpr int kLaneStep = 8;")]}),
    "k7_early_csr": (True, {"exact_sum.cu": [(_K7_CSR, ""), (
        "    const long long left = live ?",
        _K7_CSR + "    const long long left = live ?")]}),
    "k7_block_128": (True, {"exact_sum.cu": [(
        "constexpr int kLaneThreads = 256;",
        "constexpr int kLaneThreads = 128;")]}),
    "k7_block_512": (True, {"exact_sum.cu": [(
        "constexpr int kLaneThreads = 256;",
        "constexpr int kLaneThreads = 512;")]}),
    "k7_block_512_step_8": (True, {"exact_sum.cu": [
        ("constexpr int kLaneThreads = 256;",
         "constexpr int kLaneThreads = 512;"),
        ("constexpr int kLaneStep = 4;", "constexpr int kLaneStep = 8;")]}),
    # the splits of the first designs, measured before the redesign: K7's
    # loop with its words read straight from device memory (exact); K11's
    # warp a task with only lane 0's trial stored (no shuffles, no ballot;
    # wrong outputs) and with a 32-bit task / C (exact)
    "k7_no_stage": (True, {"exact_sum.cu": [
        (_K7_KERNEL, _FIRST_SHAPES + _K7_SHARED_EXCEPTIONS.replace(
            _STAGE, _DIRECT)),
        (_K7_ROWS, _K7_ROWS.replace("kLaneThreads / 32 * lane_rows<F>()",
                                    "1"))]}),
    "k11_no_reduce": (False, {"score.cu": [
        (_K11_KERNEL, _K11_WARP_TASK.replace(_REDUCE,
                                             "  const int ne = !enc.exc;\n"))]}),
    "k11_no_index": (True, {"score.cu": [
        (_K11_KERNEL, _K11_WARP_TASK.replace(_INDEX, _INDEX32))]}),
    # K11: the first design (exact), one trial a task (the task's own cost;
    # wrong outputs), and the sweeps: the loop's unroll, the tasks a block
    # aims at, and the samples' stride in shared memory (32: bank conflicts)
    "k11_warp_task": (True, {"score.cu": [(_K11_KERNEL, _K11_WARP_TASK)]}),
    "k11_one_trial": (False, {"score.cu": [(_K11_LOOP, _K11_LOOP.replace(
        "i < kSamples", "i < 1"))]}),
    "k11_unroll_1": (True, {"score.cu": [("#pragma unroll 4",
                                          "#pragma unroll 1")]}),
    "k11_unroll_8": (True, {"score.cu": [("#pragma unroll 4",
                                          "#pragma unroll 8")]}),
    "k11_unroll_32": (True, {"score.cu": [("#pragma unroll 4",
                                           "#pragma unroll 32")]}),
    "k11_block_128": (True, {"score.cu": [(
        "constexpr int kBlock = 256;", "constexpr int kBlock = 128;")]}),
    "k11_block_512": (True, {"score.cu": [(
        "constexpr int kBlock = 256;", "constexpr int kBlock = 512;")]}),
    "k11_own_64": (True, {"score.cu": [(
        "constexpr int kBlockOwn = 128;", "constexpr int kBlockOwn = 64;")]}),
    "k11_own_256": (True, {"score.cu": [(
        "constexpr int kBlockOwn = 128;", "constexpr int kBlockOwn = 256;")]}),
    "k11_stride_32": (True, {"score.cu": [(
        "constexpr int kStride = kSamples + 1;",
        "constexpr int kStride = kSamples;")]}),
}


def ptxas_lines(log: str) -> list:
    """"<kernel> <route>: <registers, spills, shared memory>" of K15-K20
    from nvcc's -Xptxas -v log."""
    out, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            kernel = next((k for k in ("key_counts_small", "key_counts",
                                       "key_extremes", "rank_pass",
                                       "vector_sums", "group_reduce",
                                       "variant_sum", "falp_exact_sum",
                                       "exact_sum", "score", "rd_stream",
                                       "rd_block", "rd_kernel")
                           if k in name), None)
            route = next((r for t, r in (("AlpVectorId", "ALP f64"),
                                         ("AlpVectorIf", "ALP f32"),
                                         ("RdVectorIm", "RD f64"),
                                         ("RdVectorIj", "RD f32"),
                                         ("IdLb0", "f64"), ("IfLb0", "f32"),
                                         ("ImLb0", "f64"), ("IjLb0", "f32"),
                                         ("IdLb1", "f64 where"),
                                         ("IfLb1", "f32 where"),
                                         ("ImLb1", "f64 where"),
                                         ("IjLb1", "f32 where"),
                                         ("kernelIdE", "f64"),
                                         ("kernelIfE", "f32"),
                                         ("ImLi64E", "f64"),
                                         ("IjLi32E", "f32"))
                          if t in name), "")
            shared = "Lb1E" in name
            entry = (f"{kernel} {route}"
                     f"{' shared' if kernel == 'group_reduce' and shared else ''}"
                     f"{' device' if kernel == 'group_reduce' and not shared else ''}"
                     if kernel else None)
        elif entry and "Used" in ln and "registers" in ln:
            out.append(f"{entry} {ln.split('info    :')[-1].strip()}")
            entry = None
    return out


SASS_OPS = ("FADD", "I2F", "F2I", "DMUL", "DADD", "LDG", "STG", "LDS",
            "STS", "BAR", "SHFL", "REDUX", "VOTE", "ATOMS", "SEL", "PRMT")
# kernel label -> (object, a substring of the kernel's mangled name, the
# opcode that marks one value or trial of its loop: K20's float add, the
# int64 -> double convert of K7's decode and of K11's verify)
SASS_KERNELS = {"k20": ("falp.o", "variant_sum_kernel", "FADD"),
                "k7": ("exact_sum.o", "falp_exact_sum_kernelIdLb0E", "I2F"),
                "k11": ("score.o", "score_kernelIdE", "I2F"),
                "k4": ("falp.o", "rd_stream_kernelIjLi32E|rd_kernelIjLi32E",
                       "STG"),
                "k6": ("exact_sum.o", "exact_sum_kernelIjLb0E", "LDG")}
# values a unit where it is not one: K6's 16-byte load holds 4 values, the
# first loop's and k6_scalar_loads' load one
UNIT_VALUES = {"k6": 4, "k6 k6_first_loop": 1, "k6 k6_no_digits": 1,
               "k6 k6_one_row_check": 1, "k6 k6_scalar_loads": 1}


def sass_loops(obj: pathlib.Path, cuobjdump: str, kernel: str,
               unit: str = "FADD") -> dict:
    """The SASS of `kernel` in object `obj` (``cuobjdump -sass``; the
    first of its names, "|"-separated, that the object holds): its
    instruction count and, in "loops", each loop that holds the opcode
    `unit` (one a value or trial), innermost first: the instructions from
    the target of its backward branch to the branch, the count of each of
    SASS_OPS and the instructions a `unit`.  A code block the compiler
    placed outside that range is not counted."""
    sass = subprocess.run([cuobjdump, "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    kernel = next((k for k in kernel.split("|") if k in sass), kernel)
    body, inside = [], False                 # (address, opcode, operands)
    for ln in sass.splitlines():
        s = ln.strip()
        if "Function :" in s:
            inside = kernel in s
        elif inside and s.startswith("/*") and ";" in s:
            words = s.split("*/", 1)[1].split(";")[0].split()
            if words[0].startswith("@"):     # a predicate
                words = words[1:]
            body.append((int(s[2:].split("*/")[0], 16), words[0],
                         words[1:]))
    if not body:
        raise SystemExit(f"no kernel {kernel} in {obj}")

    def counted(span):
        count = {k: sum(o.split(".")[0] == k for o in span)
                 for k in SASS_OPS}
        return dict(count, instructions=len(span),
                    per_unit=len(span) / max(count[unit], 1))

    loops = []
    for at, op, args in body:
        if not op.startswith("BRA") or not args[-1].startswith("0x"):
            continue
        to = int(args[-1], 16)
        span = [o for a, o, _ in body if to <= a <= at]
        if to < at and any(o.split(".")[0] == unit for o in span):
            loops.append(counted(span))
    return {"kernel": counted([o for _, o, _ in body]),
            "loops": sorted(loops, key=lambda c: c["instructions"])}


def apply_edit(text: str, old, new: str, what: str) -> str:
    """`text` with `old` replaced by `new`: `old` a string that occurs
    once, or a region (start, end) from the one occurrence of start
    through the first end after it.  Exits when the edit does not apply."""
    start, end = old if isinstance(old, tuple) else (old, "")
    at = text.find(start)
    stop = text.find(end, at + len(start)) if end else at + len(start)
    if text.count(start) != 1 or stop < 0:
        raise SystemExit(f"{what}: the edit does not apply: {start[:60]!r}")
    return text[:at] + new + text[stop + len(end):]


def build_variants(names, build, nvcc) -> dict:
    """name -> loaded ctypes library of each variant (and "base"), every
    object compiled in parallel: each source once, then each variant's
    edited sources."""
    shutil.rmtree(BUILD, ignore_errors=True)
    src_dir = ROOT / "alp_tpu_torch" / "csrc"
    sources = sorted(src_dir.glob("*.cu"))
    jobs = []                            # (variant, source name, path)

    def rebuilt(name, src):
        """Whether variant `name` compiles `src` itself (else base's)."""
        edits = {} if name == "base" else VARIANTS[name][1]
        return name == "base" or src.name in edits or any(
            f.endswith(".cuh") for f in edits)

    for name in ["base", *names]:
        d = BUILD / name
        shutil.copytree(src_dir, d)
        edits = {} if name == "base" else VARIANTS[name][1]
        for f, pairs in edits.items():
            text = (d / f).read_text()
            for old, new in pairs:
                text = apply_edit(text, old, new, f"{name}: {f}")
            (d / f).write_text(text)
        for src in sources:
            if rebuilt(name, src):
                jobs.append((name, src.name, d / src.name))
    procs = [(n, s, subprocess.Popen(
        [nvcc, *build.FLAGS, "-c", "-o", str(p.with_suffix(".o")), str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for n, s, p in jobs]
    logs = {}
    for n, s, p in procs:
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{n}/{s} does not build:\n{out}")
        logs[n, s] = out
    libs = {}
    for name in ["base", *names]:
        objs = [BUILD / (name if rebuilt(name, s) else "base")
                / f"{s.stem}.o" for s in sources]
        so = BUILD / name / "lib.so"
        subprocess.run([nvcc, *build.ARCH, "-shared", "-o", str(so),
                        *map(str, objs)], check=True)
        dll = ctypes.CDLL(str(so))
        for entry, argtypes in build.ENTRIES.items():
            fn = getattr(dll, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[name] = dll
        for f in ("keys.cu", "group.cu", "falp.cu", "exact_sum.cu",
                  "score.cu"):
            if (name, f) in logs:
                print(f"  {name}: {'; '.join(ptxas_lines(logs[name, f]))}",
                      flush=True)
    return libs


# SUM call kernel -> the label of its timing cells
SUM_LABELS = {"exact_sum_f64": "k5", "exact_sum_f32": "k6",
              "falp_decode_f64_exact_sum": "k7",
              "falp_decode_f32_exact_sum": "k8"}
# a variant's family (its name's first word) -> the kernels it changes
FAMILIES = {"keys": ("k15", "k16", "k17"), "k7": ("k7", "k8"),
            "k11": ("k11", "k14"), "k4": ("k3", "k4"), "k6": ("k5", "k6")}
# variants that change more than their family: the shared accumulator
CHANGES = {"k7_select_digits": ("k5", "k6", "k7", "k8", "k18"),
           "k6_multiply_add": ("k5", "k6", "k7", "k8", "k18"),
           "k6_carry_add": ("k5", "k6", "k7", "k8", "k18"),
           "k6_fma_add": ("k5", "k6", "k7", "k8", "k18")}
KERNELS = ("k3", "k4", "k5", "k6", "k7", "k8", "k11", "k14", "k15", "k16",
           "k17", "k18", "k19", "k20")
# the kernels timed on the ALP_RD columns alone
RD_KERNELS = {"k3", "k4", "k5", "k6"}


def changes(variant: str) -> tuple:
    """The kernels that `variant` ("base": every one) changes."""
    if variant == "base":
        return KERNELS
    family = variant.split("_")[0]
    return CHANGES.get(variant, FAMILIES.get(family, (family,)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_ablations.py: no CUDA card", file=sys.stderr)
        return 1
    only = set(sys.argv[1:]) or set(KERNELS)
    if only - set(KERNELS):
        print(f"kernel_ablations.py: unknown kernels {only - set(KERNELS)}; "
              f"choose from {KERNELS}", file=sys.stderr)
        return 2

    def timed(lname: str, kernel: str) -> bool:
        return kernel in only and kernel in changes(lname)
    sys.path.insert(0, str(ROOT))
    import alp_tpu_torch
    import chip_smoke as cs
    from alp_tpu_torch import constants as C
    from alp_tpu_torch import engine
    from alp_tpu_torch.columns import BENCH_PROFILES, route_columns
    from alp_tpu_torch.columns import tile_column
    from alp_tpu_torch.kernels import _build, falp
    from alp_tpu_torch.kernels import exact_sum as kes
    from alp_tpu_torch.kernels import group as kgroup
    from alp_tpu_torch.kernels import keys as kkeys
    from alp_tpu_torch.ops.keys import biased_keys

    dev = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)
    nvcc = _build.nvcc_path()
    libs = build_variants([v for v in VARIANTS if only & set(changes(v))],
                          _build, nvcc)
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    sass = {}
    for label, (obj, kernel, unit) in SASS_KERNELS.items():
        for lname in libs:
            if label in only and label in changes(lname) and (
                    BUILD / lname / obj).exists():
                got = sass_loops(BUILD / lname / obj, cuobjdump, kernel,
                                 unit)
                per = UNIT_VALUES.get(f"{label} {lname}",
                                      UNIT_VALUES.get(label, 1))
                for c in [got["kernel"], *got["loops"]]:
                    c["per_value"] = c["per_unit"] / per
                sass[f"{label} {lname}"] = got
                print(f"  {label} SASS {lname}: {sass[f'{label} {lname}']}",
                      flush=True)
    real_lib = _build.lib
    tile_to = dict(cs.TILE_TO, **{n: cs.BENCH_VECTORS for n in BENCH_PROFILES})
    sources = route_columns(np.random.default_rng(0), cs.SOURCE_VECTORS)
    R, T = cs.RANK_TIMED
    result = {}
    try:
        for name in COLUMNS:
            if only <= RD_KERNELS and "alp_rd" not in name:
                continue
            col = alp_tpu_torch.compress(sources[name])
            if name in tile_to:
                col = tile_column(col, tile_to[name])
            plan = col.plan(dev)
            bits = plan.run().view(plan.bits_dtype)
            x = bits.reshape(-1)[:plan.n_values].cpu().numpy().view(
                np.float64 if plan.f64 else np.float32)
            bk = biased_keys(bits.reshape(-1)[:plan.n_values])
            del bits
            cells = {}
            kcalls, gcalls = engine.key_calls(plan), engine.group_calls(plan)
            if "k15" in only:
                for E in K15_E:
                    thr_t = cs.thresholds_tensor(cs.column_thresholds(x, E), plan)
                    want = [c.counts_plain(thr_t) for c in kcalls]
                    for lname, dll in libs.items():
                        if not timed(lname, "k15") or (
                                lname == "k15_no_bins" and E != 2):
                            continue
                        _build.lib = lambda dll=dll: dll
                        if lname == "base" or VARIANTS[lname][0]:
                            for c, w in zip(kcalls, want):
                                got = c.counts(thr_t, torch.zeros(
                                    E + 1, dtype=torch.int64, device=dev))
                                if not torch.equal(got, w):
                                    raise SystemExit(f"{name}: {lname} K15 at "
                                                     f"E={E} differs from its "
                                                     f"plain version")
                        out = torch.zeros(E + 1, dtype=torch.int64, device=dev)
                        cells[f"k15 E={E} {lname}"] = cs.cuda_ms(
                            lambda: [c.counts(thr_t, out) for c in kcalls], 20)
            if "k16" in only:
                want = [c.extremes_plain() for c in kcalls]
                for lname, dll in libs.items():
                    if not timed(lname, "k16"):
                        continue
                    _build.lib = lambda dll=dll: dll
                    out = torch.zeros((plan.n_vectors, 2), dtype=plan.bits_dtype,
                                      device=dev)
                    for c, w in zip(kcalls, want):
                        if (lname == "base" or VARIANTS[lname][0]) and not (
                                torch.equal(c.extremes(out)[c.rows], w)):
                            raise SystemExit(f"{name}: {lname} K16 differs from "
                                             f"its plain version")
                    cells[f"k16 {lname}"] = cs.cuda_ms(
                        lambda: [c.extremes(out) for c in kcalls], 20)
                del want
            if "k17" in only:
                for label, (thr, br) in (
                        ("k17 disjoint", (cs.column_thresholds(x, T),
                                          cs.disjoint_brackets(x, R))),
                        ("k17 later", cs.later_pass_case(torch.sort(bk).values,
                                                         R, T))):
                    thr_t = cs.thresholds_tensor(thr, plan)
                    br_t = cs.thresholds_tensor(br, plan)
                    want = [c.rank_pass_plain(thr_t, br_t) for c in kcalls]
                    for lname, dll in libs.items():
                        if not timed(lname, "k17"):
                            continue
                        _build.lib = lambda dll=dll: dll
                        if lname == "base" or VARIANTS[lname][0]:
                            for c, w in zip(kcalls, want):
                                got = c.rank_pass(thr_t, br_t, *kkeys.rank_outputs(
                                    len(thr), R, plan.bits_dtype, dev))
                                if not all(map(torch.equal, got, w)):
                                    raise SystemExit(f"{name}: {lname} K17 "
                                                     f"differs from its plain "
                                                     f"version")
                        outs = kkeys.rank_outputs(len(thr), R, plan.bits_dtype,
                                                  dev)
                        cells[f"{label} {lname}"] = cs.cuda_ms(
                            lambda: [c.rank_pass(thr_t, br_t, *outs)
                                     for c in kcalls], 20)
            if "k18" in only:
                want = [c.vector_sums_plain() for c in gcalls]
                row = kes.WINDOWS[plan.bits_dtype] + 3
                for lname, dll in libs.items():
                    if not timed(lname, "k18"):
                        continue
                    _build.lib = lambda dll=dll: dll
                    # a sentinel, not zeros: every column must be written
                    sums = torch.full((plan.n_vectors, row), -7,
                                      dtype=torch.int64, device=dev)
                    keys = torch.full((plan.n_vectors, 2), 7,
                                      dtype=plan.bits_dtype, device=dev)
                    for c, (ws, wk) in zip(gcalls, want):
                        c.vector_sums(sums, keys)
                        if (lname == "base" or VARIANTS[lname][0]) and not (
                                torch.equal(sums[c.rows], ws)
                                and torch.equal(keys[c.rows], wk)):
                            raise SystemExit(f"{name}: {lname} K18 differs from "
                                             f"its plain version")
                    cells[f"k18 {lname}"] = cs.cuda_ms(
                        lambda: [c.vector_sums(sums, keys) for c in gcalls], 20)
                del want
            if "k20" in only:
                alp_f64 = [b for b in plan.buckets
                           if plan.f64 and b.scheme == C.SCHEME_ALP]
                want = [falp.variant_sum_plain(b.args[0], b.bw, *b.args[1:])
                        for b in alp_f64]
                for lname, dll in libs.items():
                    if not alp_f64 or not timed(lname, "k20"):
                        continue
                    _build.lib = lambda dll=dll: dll
                    if lname == "base" or VARIANTS[lname][0]:
                        for b, w in zip(alp_f64, want):
                            got = falp.variant_sum_f64(b.args[0], b.bw,
                                                       *b.args[1:])
                            if not torch.equal(got.view(torch.int32),
                                               w.view(torch.int32)):
                                raise SystemExit(f"{name}: {lname} K20 bw="
                                                 f"{b.bw} differs from its plain "
                                                 f"version")
                    cells[f"k20 {lname}"] = cs.cuda_ms(
                        lambda: [falp.variant_sum_f64(b.args[0], b.bw,
                                                      *b.args[1:])
                                 for b in alp_f64], 20)
                del want
            rd = [b for b in plan.buckets if b.scheme == C.SCHEME_ALP_RD]
            rd_label = "k3" if plan.f64 else "k4"
            if rd_label in only and rd:
                want = [falp.rd_plain(b.args[0], b.bw, b.args[1], b.lbw,
                                      *b.args[2:]) for b in rd]
                out = torch.empty((plan.n_vectors, 1024),
                                  dtype=plan.bits_dtype, device=dev)
                for lname, dll in libs.items():
                    if not timed(lname, rd_label):
                        continue
                    _build.lib = lambda dll=dll: dll
                    if lname == "base" or VARIANTS[lname][0]:
                        out.fill_(-7)
                        for b, w in zip(rd, want):
                            plan.launch(b, out)
                            if not torch.equal(out[b.rows], w):
                                raise SystemExit(f"{name}: {lname} "
                                                 f"{rd_label.upper()} rbw="
                                                 f"{b.bw} lbw={b.lbw} differs "
                                                 f"from its plain version")
                    cells[f"{rd_label} {lname}"] = cs.cuda_ms(
                        lambda: [plan.launch(b, out) for b in rd], 20)
                del want, out
            if "k19" in only:
                for G, ordered in ((16, False), (65536, False), (16, True)):
                    kv = cs.column_group_keys(plan, G, ordered, G)
                    gks = [kv[c.rows].contiguous() for c in gcalls]
                    want = [c.group_reduce_plain(gk, G)
                            for c, gk in zip(gcalls, gks)]
                    for lname, dll in libs.items():
                        if not timed(lname, "k19"):
                            continue
                        _build.lib = lambda dll=dll: dll
                        for c, gk, w in zip(gcalls, gks, want):
                            got = c.group_reduce(gk, G, *kgroup.group_outputs(
                                G, plan.bits_dtype, dev))
                            if not all(map(torch.equal, got, w)):
                                raise SystemExit(f"{name}: {lname} K19 differs "
                                                 f"from its plain version")
                        outs = kgroup.group_outputs(G, plan.bits_dtype, dev)
                        cells[f"k19 G={G}{' ordered' if ordered else ''} "
                              f"{lname}"] = cs.cuda_ms(
                            lambda: [c.group_reduce(gk, G, *outs)
                                     for c, gk in zip(gcalls, gks)], 20)
                    del kv, gks, want
            for call_kernel, label in SUM_LABELS.items():
                mine = [c for c in engine.sum_calls(plan)
                        if c.kernel == call_kernel]
                if label not in only or not mine:
                    continue
                want = [c.plain() for c in mine]
                out = kes.totals(plan.bits_dtype, dev)
                for lname, dll in libs.items():
                    if not timed(lname, label):
                        continue
                    _build.lib = lambda dll=dll: dll
                    if lname == "base" or VARIANTS[lname][0]:
                        for c, w in zip(mine, want):
                            got = c.launch(kes.totals(plan.bits_dtype, dev))
                            if not torch.equal(got, w):
                                raise SystemExit(f"{name}: {lname} "
                                                 f"{label.upper()} bw={c.bw} "
                                                 f"differs from its plain "
                                                 f"version")
                    cells[f"{label} {lname}"] = cs.cuda_ms(
                        lambda: [c.launch(out) for c in mine], 20)
                del want
                if label not in ("k5", "k6"):
                    continue
                # the filtered instance (SUM WHERE) at chip_smoke.py's key
                # range: the 5th to the 13th of 17 thresholds
                thr = cs.column_thresholds(x, 17)
                where = [c for c in engine.sum_calls(plan, (int(thr[4]),
                                                            int(thr[12])))
                         if c.kernel == call_kernel]
                want = [c.plain() for c in where]
                for lname, dll in libs.items():
                    if not timed(lname, label):
                        continue
                    _build.lib = lambda dll=dll: dll
                    if lname == "base" or VARIANTS[lname][0]:
                        for c, w in zip(where, want):
                            got = c.launch(kes.totals(plan.bits_dtype, dev))
                            if not torch.equal(got, w):
                                raise SystemExit(f"{name}: {lname} "
                                                 f"{label.upper()} with a key "
                                                 f"range differs from its "
                                                 f"plain version")
                    cells[f"{label} where {lname}"] = cs.cuda_ms(
                        lambda: [c.launch(out) for c in where], 20)
                del want
            score = "k11" if plan.f64 else "k14"
            if score in only:
                # K11 / K14 as compress_device launches them, by planning
                # level: the first scores shared pairs, the second each
                # segment's own
                _build.lib = real_lib
                _, dc_calls = cs.record_dc_calls(
                    lambda: alp_tpu_torch.compress_device(x))
                for level, shared in (("first", True), ("second", False)):
                    mine = [c for c in dc_calls
                            if c[0].startswith("score_pairs")
                            and (c[1][1].shape[0] == 1) == shared]
                    if not mine:
                        continue
                    want = [cs.dc_plain(c[0], c[1], c[2]) for c in mine]
                    launches = [ln for c in mine for ln in c[4]]
                    for lname, dll in libs.items():
                        if not timed(lname, score):
                            continue
                        _build.lib = lambda dll=dll: dll
                        if lname == "base" or VARIANTS[lname][0]:
                            for c in mine:       # every output is written
                                for t in c[5]:
                                    t.fill_(-7)
                            for e, d, args in launches:
                                falp._launch(e, d, *args)
                            for c, w in zip(mine, want):
                                if not all(map(torch.equal, c[5], w)):
                                    raise SystemExit(
                                        f"{name}: {lname} {score.upper()} "
                                        f"{level} level differs from its "
                                        f"plain version")
                        def launch():
                            return [falp._launch(e, d, *args)
                                    for e, d, args in launches]

                        cells[f"{score} {level} {lname}"] = cs.cuda_ms(
                            launch, 20)
                        # the device time alone: the launches' host cost
                        # is about a second-level kernel's
                        cells[f"{score} {level} graph {lname}"] = (
                            cs.cuda_graph_ms(launch, 20))
                del dc_calls
            result[name] = cells
            print(f"{name}: " + "; ".join(f"{k} {v:.4f}"
                                          for k, v in cells.items()),
                  flush=True)
            del bk, plan, col
    finally:
        _build.lib = real_lib
    print(json.dumps({"ms": result, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
