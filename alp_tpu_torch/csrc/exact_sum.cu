// Hand-written Hopper (sm_90a) exact-SUM kernels of alp_tpu_torch.
//
//   K5 alp_exact_sum_f64       replaces exact_sum_planes_f64
//                              (alp_tpu/kernels/falp.py:560): the SUM
//                              partials of decoded f64 bit patterns.
//   K6 alp_exact_sum_f32       replaces exact_sum_planes_f32 (:654).
//   K7 alp_falp_exact_sum_f64  replaces falp_decode_f64_variant_exact_sum
//                              (:737) for every variant and the const
//                              bucket: K1's decode fused with K5's sum.
//   K8 alp_falp_exact_sum_f32  replaces falp_decode_f32_exact_sum (:689):
//                              K2's decode fused with K6's sum.
//
// What they compute.  A finite value is m' * 2^(e_eff - B), B = 1075 for
// f64 and 150 for f32, with m' the mantissa (implicit bit restored for
// normals) and e_eff = max(biased exponent, 1).  The integer
// c = m' << (e_eff & 31) is cut into unsigned 32-bit digits d_p (3 for
// f64, c < 2^84; 2 for f32, c < 2^55); digit p lands in window
// j + p, j = e_eff >> 5, negated for a negative value.  Each kernel adds
// its values' signed digits into a column total out[W + 3] of int64: W
// windows over the whole exponent range (f64: j in 0..63 plus 2 spill
// windows, W = 66; f32: j in 0..7 plus 1, W = 9), then the counts of NaN,
// +Inf and -Inf.  The host forms sum_w out[w] << 32 w and rounds once
// (alp_tpu_torch/engine.py).  Zeros add nothing; subnormals, 1e300 and
// every exception go through the same code: there is no out-of-envelope
// row and no fallback, unlike the TPU kernels, which sum 16-bit digit
// halves in i32 over a static 4-window envelope.
//
// Exactness.  Integer addition is exact and associative, so the order of
// blocks, warps and atomics does not matter: the totals are the same on
// every run and equal the plain version's (tolerance 0).  |digit| < 2^32
// and fewer than 2^31 values a call (the wrappers check; a longer column
// is summed in runs, each into its own total) keep every total within
// int64.
//
// Pad values.  The container pads a partial last vector with the column's
// final value; position vec * 1024 + k >= n_values is skipped, with vec
// the row's real vector id (rows[i]), so a compact scratch of decoded
// ALP_RD rows masks correctly.
//
// Key range (query_filter_sum).  Each kernel has a second instantiation,
// Filter = true, that sums a value only if its IEEE-754 total-order key
// (vector.cuh order_key) lies in [klo, khi]: SUM(v) WHERE lo <= v <= hi.
// The test joins the pad test in ok[], so the filtered kernels share every
// other line with the plain SUM; query_sum's instantiations (Filter =
// false) compile to the kernels they were before the flag.  This adds no
// TPU site: the JAX package filters in its one-hot MXU pass
// (alp_tpu/engine.py _filter_sum_mxu), here the predicate rides the SUM.
//
// Exceptions (K7/K8).  The formula's value at an exception slot is a
// placeholder.  A vector with exceptions writes its decoded bits to shared
// memory, and the block overwrites its slots with the true bits, read
// through the plan's per-vector CSR (exc_ptr[vec] .. exc_ptr[vec + 1]
// into exc_index, the flat positions, and exc_bits); then the sum reads
// them back.  No correction is left for the host.
//
// Design.  As many blocks of 256 threads as the card holds at once (at
// most one per vector) walk the vectors with a grid stride; a thread holds
// 4 values of a vector (k = tid + 256 r).  Each warp keeps a base window
// Jw, the same for its 32 lanes, and each thread R + P - 1 int64 register
// windows Jw .. (R = 2 value windows: 64 binary orders of magnitude).  A
// value with j in [Jw, Jw + R) adds its digits there by selects, without
// divergence.  When a warp's values leave that range its registers are
// flushed (a warp reduction per window, lane 0 adds to the block's
// shared-memory window row) and Jw moves to the warp's lowest window; a
// value still outside (a warp spanning more than R windows: 1e300 beside
// 1.0, subnormals beside normals) adds its digits to the shared row with
// atomics.  At the end each block adds the nonzero entries of its row to
// the global total, one atomicAdd each: a few global atomics per block.
// The values of a typical vector (decimals within 19 orders of magnitude,
// or the doubles of an ALP_RD rowgroup) span at most two windows, so Jw
// settles at the first vectors and the shared fallback stays rare.
//
// Bound.  K5/K6 read each decoded value once (8 or 4 bytes) and write a
// few hundred bytes; K7/K8 read only the packed words and 32 bytes of
// metadata a vector (bw * 128 bytes for bw-bit f64 words), so no decoded
// value reaches device memory.  The exact sum itself needs about 18 (f64)
// or 15 (f32) integer operations a nonzero value (field extraction, digit
// split, signed int64 adds), and the fused decode 9-13 (f64) or 4-6 (f32)
// more (the unpack, the FOR add and the FACT product; chip_smoke.py's
// SUM_OPS counts them).  At the card's INT32 issue rate (132 SMs x 64
// lanes x 1.98 GHz on an H100 SXM) against 3.35 TB/s, K5/K6 are bound by
// their bytes and K7/K8, which read a few bits a value, by those
// operations.  The register windows, the warps' range checks and their
// reductions above are the design's overhead and are not in the bound.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "vector.cuh"

namespace {

using alp::kVector;
using alp::Num;
using alp::order_key;
using alp::stage;
using alp::unpack;
constexpr int kThreads = 256;
constexpr int kPer = kVector / kThreads;    // values of a vector a thread
constexpr int kR = 2;                       // value windows in registers
constexpr unsigned kFull = 0xffffffffu;

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
};

// atomicAdd of a signed 64-bit value (two's complement), shared or global.
__device__ __forceinline__ void atomic_add(long long* at, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(at),
            static_cast<unsigned long long>(v));
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The per-thread superaccumulator of a block.  Every thread of the block
// calls add() and finish() the same number of times (warp collectives).
template <typename U>
struct Acc {
  using Fx = Fixed<U>;
  static constexpr int kRegs = kR + Fx::P - 1;
  long long reg[kRegs];
  int base;                // Jw, warp-uniform; -1 before the first value
  unsigned cnt[3];         // NaN, +Inf, -Inf
  long long* row;          // the block's shared [W + 3] totals

  __device__ __forceinline__ explicit Acc(long long* shared_row)
      : base(-1), row(shared_row) {
#pragma unroll
    for (int w = 0; w < kRegs; ++w) reg[w] = 0;
    cnt[0] = cnt[1] = cnt[2] = 0;
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

  // One thread's kPer values of a vector; ok[r] is false for pad values.
  __device__ __forceinline__ void add(const U (&b)[kPer],
                                      const bool (&ok)[kPer]) {
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int j = ok[r] ? Fx::window(b[r]) : -1;
      if (j >= 0) {
        lo = min(lo, j);
        hi = max(hi, j);
      }
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (hi >= 0 && (base < 0 || lo < base || hi >= base + kR)) {
      if (base >= 0) flush();
      base = lo;
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (!ok[r]) continue;
      const Fx x(b[r]);
      if (x.cls) ++cnt[x.cls - 1];
      if (x.j < 0) continue;
      long long sd[Fx::P];
#pragma unroll
      for (int p = 0; p < Fx::P; ++p)
        sd[p] = x.neg ? -static_cast<long long>(x.d[p])
                      : static_cast<long long>(x.d[p]);
      const int rel = x.j - base;            // >= 0: base <= the warp's lo
      if (rel >= kR) {                       // beyond the register range
#pragma unroll
        for (int p = 0; p < Fx::P; ++p)
          if (sd[p]) atomic_add(&row[x.j + p], sd[p]);
        continue;
      }
#pragma unroll
      for (int w = 0; w < kRegs; ++w)
#pragma unroll
        for (int p = 0; p < Fx::P; ++p)
          if (w - p >= 0 && w - p < kR) reg[w] += rel == w - p ? sd[p] : 0;
    }
  }

  // Flush, add the counts, and add the block's row into the global total.
  __device__ __forceinline__ void finish(long long* out) {
    if (base >= 0) flush();
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const unsigned v = __reduce_add_sync(kFull, cnt[c]);
      if ((threadIdx.x & 31) == 0 && v) atomic_add(&row[Fx::W + c], v);
    }
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

// Whether value bits b are summed: always, or (Filter) if klo <= key <= khi.
template <bool Filter, typename U>
__device__ __forceinline__ bool selected(U b, U klo, U khi) {
  if constexpr (Filter) {
    const U key = order_key(b);
    return klo <= key && key <= khi;
  } else {
    return true;
  }
}

// K5 / K6: rows of decoded bit patterns, row i of vector vec[i].
template <typename U, bool Filter>
__global__ void __launch_bounds__(kThreads)
exact_sum_kernel(const U* __restrict__ bits,
                 const long long* __restrict__ vec, long long n,
                 long long n_values, U klo, U khi,
                 long long* __restrict__ out) {
  __shared__ long long row[Fixed<U>::W + 3];
  zero_row<U>(row);
  Acc<U> acc(row);
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const long long first = vec[i] * kVector;
    U b[kPer];
    bool ok[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int k = threadIdx.x + r * kThreads;
      b[r] = bits[i * kVector + k];
      ok[r] = first + k < n_values && selected<Filter>(b[r], klo, khi);
    }
    acc.add(b, ok);
  }
  acc.finish(out);
}

// K7 / K8: the falp decode of K1 / K2, its exceptions substituted, summed.
template <typename F, bool Filter>
__global__ void __launch_bounds__(kThreads)
falp_exact_sum_kernel(const typename Num<F>::U* __restrict__ packed, int bw,
                      const typename Num<F>::U* __restrict__ base,
                      const typename Num<F>::U* __restrict__ fact,
                      const F* __restrict__ frac,
                      const long long* __restrict__ rows,
                      const long long* __restrict__ exc_ptr,
                      const long long* __restrict__ exc_index,
                      const typename Num<F>::U* __restrict__ exc_bits,
                      long long n, long long n_values,
                      typename Num<F>::U klo, typename Num<F>::U khi,
                      long long* __restrict__ out) {
  using U = typename Num<F>::U;
  constexpr int S = Num<F>::S;
  __shared__ U words[kVector];               // bw <= S: at most 1024 words
  __shared__ U vals[kVector];
  __shared__ long long row[Fixed<U>::W + 3];
  zero_row<U>(row);
  Acc<U> acc(row);
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    __syncthreads();                         // the last vector is read
    stage<U, S>(words, packed + i * bw * (kVector / S), bw);
    __syncthreads();
    const U b0 = base[i], f = fact[i];
    const F fr = frac[i];
    const long long vec = rows[i];
    U b[kPer];
    bool ok[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int k = threadIdx.x + r * kThreads;
      const U u = bw ? unpack<U, S>(words, bw, k) : U(0);
      b[r] = Num<F>::bits(Num<F>::decode(static_cast<U>((b0 + u) * f), fr));
      ok[r] = vec * kVector + k < n_values;
    }
    const long long e0 = exc_ptr[vec], e1 = exc_ptr[vec + 1];
    if (e1 > e0) {                           // block-uniform
#pragma unroll
      for (int r = 0; r < kPer; ++r) vals[threadIdx.x + r * kThreads] = b[r];
      __syncthreads();
      for (long long e = e0 + threadIdx.x; e < e1; e += kThreads)
        vals[exc_index[e] & (kVector - 1)] = exc_bits[e];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kPer; ++r) b[r] = vals[threadIdx.x + r * kThreads];
    }
    if constexpr (Filter) {
#pragma unroll
      for (int r = 0; r < kPer; ++r)
        ok[r] = ok[r] && selected<Filter>(b[r], klo, khi);
    }
    acc.add(b, ok);
  }
  acc.finish(out);
}

// Blocks for n vectors on card `dev` (the card of the tensors): as many
// as can be resident at once (at most one per vector); each walks its
// share of the vectors.
template <typename K>
cudaError_t grid_for(K kernel, long long n, int dev, unsigned* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  const long long cap = max(static_cast<long long>(sms) * per_sm, 1ll);
  *blocks = static_cast<unsigned>(n < cap ? n : cap);
  return err;
}

// A call sums fewer than 2^31 values (n rows of 1024); n_values only
// bounds the positions that are summed.
bool bad_size(long long n, long long n_values) {
  return n < 0 || n * kVector >= (1ll << 31) || n_values < 0;
}

template <typename U, bool Filter>
int launch_exact_sum(const void* bits, const void* vec, long long n,
                     long long n_values, U klo, U khi, void* out, int dev,
                     void* stream) {
  if (bad_size(n, n_values)) return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  const cudaError_t err =
      grid_for(exact_sum_kernel<U, Filter>, n, dev, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    exact_sum_kernel<U, Filter><<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const U*>(bits), static_cast<const long long*>(vec), n,
        n_values, klo, khi, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename F, bool Filter>
int launch_falp_exact_sum(const void* packed, int bw, const void* base,
                          const void* fact, const void* frac,
                          const void* rows, const void* exc_ptr,
                          const void* exc_index, const void* exc_bits,
                          long long n, long long n_values,
                          typename Num<F>::U klo, typename Num<F>::U khi,
                          void* out, int dev, void* stream) {
  using U = typename Num<F>::U;
  if (bad_size(n, n_values) || bw < 0 || bw > Num<F>::S)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  const cudaError_t err =
      grid_for(falp_exact_sum_kernel<F, Filter>, n, dev, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    falp_exact_sum_kernel<F, Filter><<<blocks, kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const U*>(packed), bw, static_cast<const U*>(base),
        static_cast<const U*>(fact), static_cast<const F*>(frac),
        static_cast<const long long*>(rows),
        static_cast<const long long*>(exc_ptr),
        static_cast<const long long*>(exc_index),
        static_cast<const U*>(exc_bits), n, n_values, klo, khi,
        static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers on card
// `dev`, which the caller has made current; out is the int64 [W + 3]
// column total, added into.  Every entry returns cudaGetLastError() (or
// the error of its device query).

extern "C" int alp_exact_sum_f64(const void* bits, const void* vec,
                                 long long n, long long n_values, void* out,
                                 int dev, void* stream) {
  return launch_exact_sum<uint64_t, false>(bits, vec, n, n_values, 0, 0,
                                           out, dev, stream);
}

extern "C" int alp_exact_sum_f32(const void* bits, const void* vec,
                                 long long n, long long n_values, void* out,
                                 int dev, void* stream) {
  return launch_exact_sum<uint32_t, false>(bits, vec, n, n_values, 0, 0,
                                           out, dev, stream);
}

extern "C" int alp_falp_exact_sum_f64(
    const void* packed, int bw, const void* base, const void* fact,
    const void* frac, const void* rows, const void* exc_ptr,
    const void* exc_index, const void* exc_bits, long long n,
    long long n_values, void* out, int dev, void* stream) {
  return launch_falp_exact_sum<double, false>(
      packed, bw, base, fact, frac, rows, exc_ptr, exc_index, exc_bits, n,
      n_values, 0, 0, out, dev, stream);
}

extern "C" int alp_falp_exact_sum_f32(
    const void* packed, int bw, const void* base, const void* fact,
    const void* frac, const void* rows, const void* exc_ptr,
    const void* exc_index, const void* exc_bits, long long n,
    long long n_values, void* out, int dev, void* stream) {
  return launch_falp_exact_sum<float, false>(
      packed, bw, base, fact, frac, rows, exc_ptr, exc_index, exc_bits, n,
      n_values, 0, 0, out, dev, stream);
}

// The filtered twins (Filter = true): the same arguments and the key range
// [klo, khi] (unsigned keys; the f32 entries use their low 32 bits) just
// before out.

extern "C" int alp_exact_sum_where_f64(const void* bits, const void* vec,
                                       long long n, long long n_values,
                                       unsigned long long klo,
                                       unsigned long long khi, void* out,
                                       int dev, void* stream) {
  return launch_exact_sum<uint64_t, true>(bits, vec, n, n_values, klo, khi,
                                          out, dev, stream);
}

extern "C" int alp_exact_sum_where_f32(const void* bits, const void* vec,
                                       long long n, long long n_values,
                                       unsigned long long klo,
                                       unsigned long long khi, void* out,
                                       int dev, void* stream) {
  return launch_exact_sum<uint32_t, true>(
      bits, vec, n, n_values, static_cast<uint32_t>(klo),
      static_cast<uint32_t>(khi), out, dev, stream);
}

extern "C" int alp_falp_exact_sum_where_f64(
    const void* packed, int bw, const void* base, const void* fact,
    const void* frac, const void* rows, const void* exc_ptr,
    const void* exc_index, const void* exc_bits, long long n,
    long long n_values, unsigned long long klo, unsigned long long khi,
    void* out, int dev, void* stream) {
  return launch_falp_exact_sum<double, true>(
      packed, bw, base, fact, frac, rows, exc_ptr, exc_index, exc_bits, n,
      n_values, klo, khi, out, dev, stream);
}

extern "C" int alp_falp_exact_sum_where_f32(
    const void* packed, int bw, const void* base, const void* fact,
    const void* frac, const void* rows, const void* exc_ptr,
    const void* exc_index, const void* exc_bits, long long n,
    long long n_values, unsigned long long klo, unsigned long long khi,
    void* out, int dev, void* stream) {
  return launch_falp_exact_sum<float, true>(
      packed, bw, base, fact, frac, rows, exc_ptr, exc_index, exc_bits, n,
      n_values, static_cast<uint32_t>(klo), static_cast<uint32_t>(khi), out,
      dev, stream);
}
