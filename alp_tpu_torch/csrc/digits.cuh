// The exact-SUM digits of one value and the per-block superaccumulator,
// shared by the SUM kernels K5-K8 (exact_sum.cu) and the grouped kernels
// K18/K19 (group.cu).
//
// Window layout.  A finite value is m' * 2^(e_eff - B), B = 1075 for f64
// and 150 for f32, with m' the mantissa (implicit bit restored for
// normals) and e_eff = max(biased exponent, 1).  The integer
// c = m' << (e_eff & 31) is cut into unsigned 32-bit digits d_p (3 for
// f64, c < 2^84; 2 for f32, c < 2^55); digit p lands in window
// j + p, j = e_eff >> 5, negated for a negative value.  A total is a row of
// int64 [W + 3]: W windows over the whole exponent range (f64: j in 0..63
// plus 2 spill windows, W = 66; f32: j in 0..7 plus 1, W = 9), then the
// counts of NaN, +Inf and -Inf.  The host forms sum_w row[w] << 32 w and
// rounds once.  |digit| < 2^32, so a window stays exact in int64 for fewer
// than 2^31 values (and, summed with wrapping atomics, for any terms whose
// true total is such a sum: exact_sum.cu).
//
// Acc, the per-thread superaccumulator of a block: each warp keeps a base
// window Jw, the same for its 32 lanes, and each thread kAccR + P - 1
// int64 register windows Jw .. (kAccR = 2 value windows: 64 binary orders
// of magnitude).  A value with j in [Jw, Jw + kAccR) adds its digits there
// without divergence: its window is computed once, its digits by funnel
// shifts of the mantissa's halves, each placed by a 32-bit select on
// j == Jw + q and added, times the value's sign, into every register
// window (a zero or a value not summed adds 0); the test against the top of
// the range is made once a warp, and a warp of zeros or pad adds nothing.
// The first design computed the window twice, negated each digit in 64
// bits and added it by a 64-bit select for each (window, digit) pair
// (kernel_ablations.py's k7_select_digits); the next tested every value
// against the top of the range and added in every warp (k6_multiply_add).
// Two sign adds were weighed against the multiply: the digit XORed with the
// sign mask and added with a carry in (k6_carry_add), and the sign as the
// multipliers (1, 0) or (2^32 - 1, 2^32 - 1) of two 32-bit multiply-adds
// (k6_fma_add).  When a warp's values leave that range its registers are
// flushed (a warp reduction per window, lane 0 adds to
// the block's shared-memory row) and Jw moves to the warp's lowest window;
// a value still outside (a warp spanning more than kAccR windows: 1e300
// beside 1.0, subnormals beside normals) adds its digits to the shared row
// with atomics, and so do the counts of the rare NaN and +-Inf.  settle()
// leaves the block's totals in the shared row (K5-K8).  K18 sums one
// vector a row and calls add() once a row: instead of settle(), store()
// puts each warp's register windows, summed over the warp, and its base
// window into slots of the warp's own with plain stores, which the block
// gathers (group.cu), so that only the rare digits outside a warp's
// windows and the rare counts take the shared row's atomics.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "vector.cuh"

namespace alp {

constexpr int kAccThreads = 256;
constexpr int kAccPer = kVector / kAccThreads;   // values of a vector a thread
constexpr int kAccR = 2;                         // value windows in registers

// One value's fixed-point digits: window j (-1: adds nothing), its P
// digits, its sign, and its class (0 finite, 1 NaN, 2 +Inf, 3 -Inf).
// window() is j alone, for the warp's range check before the sum.
template <typename U> struct Fixed;
template <> struct Fixed<uint64_t> {
  static constexpr int W = 66, P = 3;
  int j, cls;
  bool neg;
  uint32_t d[P];
  static __device__ __forceinline__ int window(uint64_t b) {
    const uint32_t e = static_cast<uint32_t>(b >> 52) & 0x7FFu;
    return e == 0x7FFu || (b << 1) == 0 ? -1
                                        : static_cast<int>(max(e, 1u) >> 5);
  }
  __device__ __forceinline__ explicit Fixed(uint64_t b) {
    const uint32_t e = static_cast<uint32_t>(b >> 52) & 0x7FFu;
    const uint64_t m = b & ((1ull << 52) - 1);
    neg = (b >> 63) != 0;
    cls = e == 0x7FFu ? (m ? 1 : (neg ? 3 : 2)) : 0;
    const uint64_t mp = cls ? 0 : (e ? m | (1ull << 52) : m);
    const uint32_t ee = max(e, 1u);
    const int sh = ee & 31;
    const uint64_t lo = mp << sh;
    d[0] = static_cast<uint32_t>(lo);
    d[1] = static_cast<uint32_t>(lo >> 32);
    d[2] = sh ? static_cast<uint32_t>(mp >> (64 - sh)) : 0u;
    j = mp ? static_cast<int>(ee >> 5) : -1;
  }
  static __device__ __forceinline__ bool special(uint64_t b) {
    return (static_cast<uint32_t>(b >> 52) & 0x7FFu) == 0x7FFu;
  }
  // The digits d of a value whose window() is not -1, from the mantissa's
  // 32-bit halves by funnel shifts (garbage for a NaN or an Inf).
  static __device__ __forceinline__ void digits(uint64_t b, uint32_t (&d)[P]) {
    const uint32_t hi = static_cast<uint32_t>(b >> 32);
    const uint32_t lo = static_cast<uint32_t>(b);
    const uint32_t e = (hi >> 20) & 0x7FFu;
    const uint32_t m1 = (hi & 0xFFFFFu) | (e ? 0x100000u : 0u);
    const int sh = max(e, 1u) & 31;
    d[0] = lo << sh;
    d[1] = __funnelshift_l(lo, m1, sh);
    d[2] = __funnelshift_l(m1, 0u, sh);
  }
};
template <> struct Fixed<uint32_t> {
  static constexpr int W = 9, P = 2;
  int j, cls;
  bool neg;
  uint32_t d[P];
  static __device__ __forceinline__ int window(uint32_t b) {
    const uint32_t e = (b >> 23) & 0xFFu;
    return e == 0xFFu || (b << 1) == 0 ? -1
                                       : static_cast<int>(max(e, 1u) >> 5);
  }
  __device__ __forceinline__ explicit Fixed(uint32_t b) {
    const uint32_t e = (b >> 23) & 0xFFu;
    const uint32_t m = b & ((1u << 23) - 1);
    neg = (b >> 31) != 0;
    cls = e == 0xFFu ? (m ? 1 : (neg ? 3 : 2)) : 0;
    const uint32_t mp = cls ? 0u : (e ? m | (1u << 23) : m);
    const uint32_t ee = max(e, 1u);
    const uint64_t c = static_cast<uint64_t>(mp) << (ee & 31);
    d[0] = static_cast<uint32_t>(c);
    d[1] = static_cast<uint32_t>(c >> 32);
    j = mp ? static_cast<int>(ee >> 5) : -1;
  }
  static __device__ __forceinline__ bool special(uint32_t b) {
    return ((b >> 23) & 0xFFu) == 0xFFu;
  }
  static __device__ __forceinline__ void digits(uint32_t b, uint32_t (&d)[P]) {
    const uint32_t e = (b >> 23) & 0xFFu;
    const uint32_t m = (b & 0x7FFFFFu) | (e ? 0x800000u : 0u);
    const int sh = max(e, 1u) & 31;
    d[0] = m << sh;
    d[1] = __funnelshift_l(m, 0u, sh);
  }
};

// atomicAdd of a signed 64-bit value (two's complement), shared or global.
__device__ __forceinline__ void atomic_add(long long* at, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(at),
            static_cast<unsigned long long>(v));
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// The per-thread superaccumulator of a block.  Every thread of the block
// calls add() and settle() (or finish()) the same number of times (warp
// collectives).
template <typename U>
struct Acc {
  using Fx = Fixed<U>;
  static constexpr int kRegs = kAccR + Fx::P - 1;
  long long reg[kRegs];
  int base;                // Jw, warp-uniform; -1 before the first value
  long long* row;          // the block's shared [W + 3] totals

  __device__ __forceinline__ explicit Acc(long long* shared_row)
      : base(-1), row(shared_row) {
#pragma unroll
    for (int w = 0; w < kRegs; ++w) reg[w] = 0;
  }

  // Register window w holds window base + w; a nonzero one is always a
  // real window (<= W - 1), since only j + p of a summed value reaches it.
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int w = 0; w < kRegs; ++w) {
      const long long v = warp_sum(reg[w]);
      if ((threadIdx.x & 31) == 0 && v) atomic_add(&row[base + w], v);
      reg[w] = 0;
    }
  }

  // One thread's N values (K5/K6: kSumVals of a row; K7/K8: kLaneStep
  // of a FastLanes lane, or an exception's true bits and its negated
  // placeholder); ok[r] is false for values that are not summed (the pad).
  // Each value's window is computed once.  A value in the warp's register
  // range adds its P digits, placed by a select a window on j == Jw + q,
  // into all kRegs windows unconditionally, times its sign (+1 or -1); a
  // window the value does not reach takes 0, and so does a zero, a NaN, an
  // Inf or a value not summed (j = -1, never a window of the range once the
  // warp holds a finite nonzero value; before that, in a warp of zeros or
  // pad, the adds are skipped).  Digits beyond the range take the shared
  // row, behind a test that is the same for the warp.
  template <int N>
  __device__ __forceinline__ void add(const U (&b)[N], const bool (&ok)[N]) {
    int j[N];
    unsigned lo = UINT_MAX;                  // j = -1 is the largest unsigned
    int hi = -1;
    bool special = false;                    // a NaN or an Inf among them
#pragma unroll
    for (int r = 0; r < N; ++r) {
      j[r] = ok[r] ? Fx::window(b[r]) : -1;
      special |= ok[r] && Fx::special(b[r]);
      lo = min(lo, static_cast<unsigned>(j[r]));
      hi = max(hi, j[r]);
    }
    lo = __reduce_min_sync(kFullMask, lo);
    hi = __reduce_max_sync(kFullMask, hi);
    if (hi >= 0 && (base < 0 || static_cast<int>(lo) < base ||
                    hi >= base + kAccR)) {
      if (base >= 0) flush();
      base = static_cast<int>(lo);
    }
    if (hi >= base + kAccR) {                // beyond the register range
#pragma unroll
      for (int r = 0; r < N; ++r)
        if (j[r] >= base + kAccR) {
          uint32_t d[Fx::P];
          Fx::digits(b[r], d);
          const long long sgn = (b[r] >> (8 * sizeof(U) - 1)) ? -1 : 1;
#pragma unroll
          for (int p = 0; p < Fx::P; ++p)
            if (d[p]) atomic_add(&row[j[r] + p], sgn * d[p]);
        }
    }
    if (hi >= 0) {                           // base >= 0 from here
#pragma unroll
      for (int r = 0; r < N; ++r) {
        uint32_t d[Fx::P];
        Fx::digits(b[r], d);
        const long long sgn = (b[r] >> (8 * sizeof(U) - 1)) ? -1 : 1;
#pragma unroll
        for (int w = 0; w < kRegs; ++w) {
          uint32_t dw = 0;
#pragma unroll
          for (int q = 0; q < kAccR; ++q)
            if (w - q >= 0 && w - q < Fx::P)
              dw = j[r] == base + q ? d[w - q] : dw;
          reg[w] += sgn * static_cast<long long>(dw);
        }
      }
    }
    // NaN and +-Inf are rare: where the warp holds one, each class is
    // counted with a ballot a value and lane 0 adds the count into the
    // shared row (no per-thread counters: registers, and an index
    // cnt[cls - 1] the compiler cannot resolve would put the whole
    // accumulator in local memory)
    if (__any_sync(kFullMask, special)) {
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const int cls = ok[r] ? Fx(b[r]).cls : 0;
#pragma unroll
        for (int c = 1; c <= 3; ++c) {
          const int k = __popc(__ballot_sync(kFullMask, cls == c));
          if ((threadIdx.x & 31) == 0 && k)
            atomic_add(&row[Fx::W + c - 1], k);
        }
      }
    }
  }

  // Flush the registers into the shared row; the row holds the block's
  // totals after the caller's next barrier.
  __device__ __forceinline__ void settle() {
    if (base >= 0) flush();
  }

  // After one add() of N <= 64 values (K18): lane 0 stores the warp's sum
  // of each register window at part[0 .. kRegs) and the base window at
  // *pbase (-1: the warp holds no finite nonzero value).  A register holds
  // at most N digits of one add() (|reg| < 2^38), so the warp sums its
  // signed 16-bit-split halves with one redux each (|sum of the high
  // halves| < 2^27).
  __device__ __forceinline__ void store(long long* part, int* pbase) const {
    const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
    for (int w = 0; w < kRegs; ++w) {
      const int lo = __reduce_add_sync(
          kFullMask, static_cast<int>(reg[w] & 0xffff));
      const int hi = __reduce_add_sync(
          kFullMask, static_cast<int>(reg[w] >> 16));
      if (lead) part[w] = static_cast<long long>(hi) * 65536 + lo;
    }
    if (lead) *pbase = base;
  }

  // settle(), then add the block's row into the global total.
  __device__ __forceinline__ void finish(long long* out) {
    settle();
    __syncthreads();
    for (int i = threadIdx.x; i < Fx::W + 3; i += blockDim.x)
      if (row[i]) atomic_add(&out[i], row[i]);
  }
};

template <typename U>
__device__ __forceinline__ void zero_row(long long* row) {
  for (int i = threadIdx.x; i < Fixed<U>::W + 3; i += blockDim.x) row[i] = 0;
  __syncthreads();
}

}  // namespace alp
