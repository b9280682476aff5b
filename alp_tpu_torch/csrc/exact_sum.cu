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
// int64.  K7/K8 add two more terms an exception (below), and that bound
// still holds without a smaller run: every add into the block's shared row
// and into the total is an unsigned (wrapping) atomic, so each window of
// the total is exact modulo 2^64, and its true value is the sum of the
// digits of the summed values alone, fewer than 2^31 terms of |digit| <
// 2^32, because each placeholder's negated digits cancel the ones the
// stream added for it in the same windows.  A thread's registers hold at
// most 3 * 2^23 terms between flushes (2^21 rows, 8 warps a block, 64
// values a lane), far within int64.  So engine.exact_sum_totals keeps its
// runs of < 2^31 values.
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
// placeholder, always finite (an integer converted, times 10^-e).  The
// stream sums it like any value; then a lane of the warp that loaded the
// exception, through the plan's per-vector CSR (exc_ptr[vec] ..
// exc_ptr[vec + 1] into exc_index, the flat positions, and exc_bits), adds
// the true bits and the placeholder with its sign flipped, whose digits
// are the negation of the ones added: each under the pad test and, with a
// key range, each under its own key test (the placeholder's the one the
// stream applied).  A NaN or an Inf among the true bits is counted like
// any value; the placeholder never is one.  No correction is left for the
// host, and no barrier, shared copy or second pass over the values.
//
// Design.  K5/K6: as many blocks of 1024 threads as the card holds at once
// walk the rows with a grid stride, eight rows a block at a time; a thread
// takes 8 adjacent values of a row an add(), by 16-byte loads (K6 twice
// K5's values a byte, so its time is the instructions a value: the first
// loop's 4 scalar loads at k = tid + 256 r, one add() of 4 values and a
// 64-bit pad test a value are kernel_ablations.py's k6_first_loop,
// k6_scalar_loads and k6_four_per_add).  K7/K8: one thread a
// FastLanes lane, reading its fields as a stream (fastlanes.cuh
// LaneStream, as K20 does: each packed word loaded once, from device
// memory, a funnel shift and a mask a field), 4 fields an add(); a warp
// takes 2 (f64) or 1 (f32) rows at a time with a grid stride over warps,
// with no barrier and no shared memory but the block's row.  Both add into
// digits.cuh's Acc, warp register windows over a shared-memory row: each
// value's window computed once, its digits placed by a select a window and
// added with their sign into every register window.  At the end each
// block adds the nonzero entries of its row to the global total, one
// atomicAdd each: a few global atomics per block.  The values of a typical
// vector (decimals within 19 orders of magnitude, or the doubles of an
// ALP_RD rowgroup) span at most two windows, so a warp's base window
// settles at the first vectors and the shared fallback stays rare.  The
// first design of K7/K8 staged each row's words in shared memory behind two
// barriers, took 4 values a thread by unpack(), patched the exceptions
// through a shared copy of the row behind two more, and added the digits
// by 64-bit select chains; kernel_ablations.py times each of those parts
// against the kept ones (k7_staged, k7_shared_exceptions,
// k7_select_digits).
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
#include <type_traits>
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
using alp::unpack;
using alp::zero_row;

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

// K5 / K6: rows of decoded bit patterns, row i of vector vec[i].  A thread
// takes kSumVals values of a row an add(), by 16-byte loads of adjacent
// values (a warp's load is 512 contiguous bytes); P = 1024 / kSumVals
// threads take a row, so a block takes kSumThreads / P rows at a time, on a
// grid stride.  The pad test is one compare a value, against the count of
// the row's real values from the thread's first one.
constexpr int kSumThreads = 1024;
constexpr int kSumVals = 8;                  // a thread's values an add()

// The 16 / sizeof(U) values at p (16-byte aligned) by one load.
template <typename U>
__device__ __forceinline__ void load16(const U* p, U* b) {
  if constexpr (sizeof(U) == 8) {
    const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(p);
    b[0] = w.x;
    b[1] = w.y;
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    b[0] = w.x;
    b[1] = w.y;
    b[2] = w.z;
    b[3] = w.w;
  }
}

template <typename U, bool Filter>
__global__ void __launch_bounds__(kSumThreads)
exact_sum_kernel(const U* __restrict__ bits,
                 const long long* __restrict__ vec, long long n,
                 long long n_values, U klo, U khi,
                 long long* __restrict__ out) {
  constexpr int V = 16 / sizeof(U);          // values a 16-byte load
  constexpr int P = kVector / kSumVals;      // threads a row
  constexpr int R = kSumThreads / P;         // rows a block at a time
  static_assert(kSumVals % V == 0 && kSumThreads % P == 0, "whole rows");
  __shared__ long long row[Fixed<U>::W + 3];
  zero_row<U>(row);
  Acc<U> acc(row);
  const int t = threadIdx.x % P;
  for (long long i0 = static_cast<long long>(blockIdx.x) * R; i0 < n;
       i0 += static_cast<long long>(gridDim.x) * R) {   // block-uniform
    const long long i = i0 + threadIdx.x / P;
    const bool live = i < n;                 // the last rows may end
    const long long ic = live ? i : i0;
    // the row's real values from the thread's first one on
    const long long rest = live ? n_values - vec[ic] * kVector - V * t : 0;
    const int lim = static_cast<int>(rest < 0 ? 0 : min(rest, 1ll * kVector));
    U b[kSumVals];
    bool ok[kSumVals];
#pragma unroll
    for (int q = 0; q < kSumVals / V; ++q) {
      load16(bits + ic * kVector + V * (t + q * P), &b[q * V]);
#pragma unroll
      for (int c = 0; c < V; ++c)
        ok[q * V + c] = V * q * P + c < lim &&
                        selected<Filter>(b[q * V + c], klo, khi);
    }
    acc.add(b, ok);
  }
  acc.finish(out);
}

// K7 / K8: the falp decode of K1 / K2 summed, its exceptions corrected.
// One thread a FastLanes lane (L = 1024 / S lanes a vector: 16 for f64,
// 32 for f32), so a warp takes 32 / L vectors; the warps walk the bucket's
// rows with a grid stride and no barrier.
constexpr int kLaneThreads = 256;
constexpr int kLaneStep = 4;                 // a lane's values an add()

template <typename F>
__host__ __device__ constexpr int lane_rows() {   // rows a warp
  return 32 / (kVector / Num<F>::S);
}

template <typename F, bool Filter>
__global__ void __launch_bounds__(kLaneThreads)
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
  constexpr int S = Num<F>::S, L = kVector / S, R = lane_rows<F>();
  constexpr U kSign = U(1) << (S - 1);
  __shared__ long long row[Fixed<U>::W + 3];
  zero_row<U>(row);
  Acc<U> acc(row);
  const int lane = threadIdx.x & 31, ln = lane % L;
  const long long warps = static_cast<long long>(gridDim.x) *
                          (kLaneThreads / 32);
  for (long long i0 = (static_cast<long long>(blockIdx.x) *
                       (kLaneThreads / 32) + threadIdx.x / 32) * R;
       i0 < n; i0 += warps * R) {
    const long long i = i0 + lane / L;
    const bool live = i < n;                 // the last warp's rows may end
    const long long ic = live ? i : i0;
    const U b0 = base[ic], f = fact[ic];
    const F fr = frac[ic];
    const long long vec = rows[ic];
    // slots k < lim of the row are summed (the pad and a dead row not)
    const long long left = live ? n_values - vec * kVector : 0;
    const int lim = static_cast<int>(left < 0 ? 0 : min(left, 1ll * kVector));
    // the lane's values, from its stream of fields or, at bit width 0
    // (uniform over the launch), from no words at all
    const auto lane_values = [&](auto packed_words) {
      alp::LaneStream<U> in(packed + ic * bw * L + ln, bw);
      for (int s = 0; s < S; s += kLaneStep) {
        U b[kLaneStep];
        bool ok[kLaneStep];
#pragma unroll
        for (int q = 0; q < kLaneStep; ++q) {
          const U u = decltype(packed_words)::value ? in.next() : U(0);
          b[q] = Num<F>::bits(
              Num<F>::decode(static_cast<U>((b0 + u) * f), fr));
          ok[q] = (s + q) * L + ln < lim && selected<Filter>(b[q], klo, khi);
        }
        acc.add(b, ok);
      }
    };
    if (bw)
      lane_values(std::true_type{});
    else
      lane_values(std::false_type{});
    // The warp's exceptions: its rows' CSR ranges, concatenated, in turns of
    // 32; a lane adds an exception's true bits and subtracts the
    // placeholder the stream summed at its slot, each under the pad test
    // and its own key test.
    long long first[R], count[R], total = 0;
    const long long e0 = live ? exc_ptr[vec] : 0;
    const long long e1 = live ? exc_ptr[vec + 1] : 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      first[r] = __shfl_sync(alp::kFullMask, e0, r * L);
      count[r] = __shfl_sync(alp::kFullMask, e1 - e0, r * L);
      total += count[r];
    }
    for (long long t0 = 0; t0 < total; t0 += 32) {   // the same for the warp
      U x[2] = {0, 0};
      bool xok[2] = {false, false};
      long long t = t0 + lane;
      if (t < total) {
        // the entry's row r by selects (first[r] with r unknown to the
        // compiler would put the arrays in local memory)
        int r = 0;
        long long e = first[0] + t;
#pragma unroll
        for (int q = 0; q + 1 < R; ++q)
          if (r == q && t >= count[q]) {
            t -= count[q];
            r = q + 1;
            e = first[q + 1] + t;
          }
        const long long ir = i0 + r;
        const int k = static_cast<int>(exc_index[e] & (kVector - 1));
        const U u = bw ? unpack<U, S>(packed + ir * bw * L, bw, k) : U(0);
        const U ph = Num<F>::bits(Num<F>::decode(
            static_cast<U>((base[ir] + u) * fact[ir]), frac[ir]));
        const bool in_col = rows[ir] * kVector + k < n_values;
        x[0] = exc_bits[e];
        x[1] = ph ^ kSign;
        xok[0] = in_col && selected<Filter>(x[0], klo, khi);
        xok[1] = in_col && selected<Filter>(ph, klo, khi);
      }
      acc.add(x, xok);
    }
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
  constexpr long long kRows = kSumThreads / (kVector / kSumVals);
  if (bad_size(n, n_values)) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(bits) % 16)   // the 16-byte loads
    return static_cast<int>(cudaErrorMisalignedAddress);
  unsigned blocks = 0;
  const cudaError_t err =
      grid_for(exact_sum_kernel<U, Filter>, (n + kRows - 1) / kRows, dev,
               kSumThreads, 0, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    exact_sum_kernel<U, Filter><<<blocks, kSumThreads, 0,
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
  constexpr long long kRows = kLaneThreads / 32 * lane_rows<F>();
  unsigned blocks = 0;
  const cudaError_t err =
      grid_for(falp_exact_sum_kernel<F, Filter>, (n + kRows - 1) / kRows,
               dev, kLaneThreads, 0, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    falp_exact_sum_kernel<F, Filter><<<blocks, kLaneThreads, 0,
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
