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
// What they compute.  Each kernel adds its values' signed 32-bit digits
// into a column total out[W + 3] of int64 in the window layout of
// digits.cuh (W windows over the whole exponent range, then the counts of
// NaN, +Inf and -Inf); the host forms sum_w out[w] << 32 w and rounds once
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
// 4 values of a vector (k = tid + 256 r) and adds them into digits.cuh's
// Acc, warp register windows over a shared-memory row.  At the end each
// block adds the nonzero entries of its row to the global total, one
// atomicAdd each: a few global atomics per block.  The values of a typical
// vector (decimals within 19 orders of magnitude, or the doubles of an
// ALP_RD rowgroup) span at most two windows, so a warp's base window
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

#include <cstdint>
#include <cuda_runtime.h>

#include "digits.cuh"
#include "vector.cuh"

namespace {

using alp::Acc;
using alp::Fixed;
using alp::grid_for;
using alp::kVector;
using alp::Num;
using alp::order_key;
using alp::stage;
using alp::unpack;
using alp::zero_row;
constexpr int kThreads = alp::kAccThreads;
constexpr int kPer = alp::kAccPer;           // values of a vector a thread

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
      grid_for(exact_sum_kernel<U, Filter>, n, dev, kThreads, 0, &blocks);
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
      grid_for(falp_exact_sum_kernel<F, Filter>, n, dev, kThreads, 0,
               &blocks);
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
