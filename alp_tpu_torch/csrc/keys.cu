// Hand-written Hopper (sm_90a) key kernels of alp_tpu_torch: the
// predicate and order queries (COUNT WHERE, MIN/MAX, TOP-K, histogram) and
// the rank passes of QUANTILE / MEDIAN.
//
//   K15 key_counts    prefix counts of total-order keys, fused with the
//                     decode.  Replaces, in alp_tpu/kernels/falp.py, the
//                     COUNT kernels falp_decode_f64_variant_count (:890),
//                     falp_decode_f64_count (:1190), falp_decode_f32_count
//                     (:1299), rd_decode_dict_f64_count (:1578) and
//                     rd_decode_dict_f32_count (:2353), and the
//                     multi-threshold prefix counts
//                     falp_decode_f64_variant_prefix_counts (:1112),
//                     rd_decode_dict_f64_prefix_counts (:1677),
//                     falp_decode_f32_prefix_counts (:1788) and
//                     rd_decode_dict_f32_prefix_counts (:1881).
//   K16 key_extremes  the least and the largest key of each vector, fused
//                     with the decode.  Replaces the key-max kernels
//                     falp_decode_f64_variant_keymax (:1052),
//                     rd_decode_dict_f64_keymax (:1624),
//                     falp_decode_f32_keymax (:1746) and
//                     rd_decode_dict_f32_keymax (:1830); their `invert`
//                     (smallest-first TOP-K) is the least key here.
//   K17 rank_pass     one pass of the quantile bisection, fused with the
//                     decode: K15's bins at T thresholds plus, for each of
//                     R brackets [lo_r, hi_r], the least and the largest
//                     key that lies in it.  Replaces the rank-pass kernels
//                     falp_decode_f64_variant_rankpass (:2100),
//                     rd_decode_dict_f64_rankpass (:2160),
//                     falp_decode_f32_rankpass (:2238) and
//                     rd_decode_dict_f32_rankpass (:2295).
//
// Each is one template over the four routes of vector.cuh (ALP f64, ALP
// f32, ALP_RD f64, ALP_RD f32), so twelve C entries.
//
// K15.  E ascending thresholds thr_0 < ... < thr_{E-1} (unsigned keys; E
// at most kMaxThr, which keeps a block's static shared memory under
// 48 KB).  Every value of the bucket that is not pad adds 1 to bin
// p = #{thresholds < key}, found by a binary search in shared memory; the
// warp's lanes that share a bin add to the block's shared histogram with
// one atomic (__match_any_sync), and each block adds its nonzero bins to
// the global int64 [E + 1] bins once.  #{key <= thr_e} is the sum of bins
// 0..e.  The TPU kernels instead compare every key with every threshold
// in its 128 lanes and leave the exceptions and the pad to host
// corrections; here the exceptions are written in and the pad skipped, so
// the counts are final.
//
// K16.  A thread's least and largest key over its values, then warp
// shuffles, one shared row a block, and thread 0 writes the pair at row
// rows[i] of out [n_vectors, 2].  The TPU kernels keep a key max per lane
// column of 128 lanes in biased i32 words; Hopper compares 64-bit
// integers, so the key is one unsigned word.
//
// K17.  K15's binning (the same device functions), then 2R compares a
// value against the brackets held in shared memory; each thread keeps a
// running (least, largest) pair a rank in registers across its vectors
// (R <= kMaxRanks, unrolled), and at the end a warp and a block reduction
// merge them and thread r adds rank r's pair into mm [R, 2] with one
// atomicMin and one atomicMax.  The caller starts mm at (all ones, 0), so
// a bracket that holds no value of the bucket leaves it untouched.  The
// TPU kernels split each key into two biased i32 words and compare them
// lexicographically per lane; here a key is one unsigned word.
//
// Bound.  All three read only the packed words, the metadata, the row ids
// and the exceptions of their vectors (a few bits a value) and write a few
// bins or keys, so they are bound by operations: the decode's (K1-K4's
// unpack, FOR add, FACT product, conversion and product, or the RD glue),
// about 3 for the key, then ceil(log2(E + 1)) search steps (K15, K17) and
// 2 compares (K16) or 4R compares, mins and maxes (K17) a value, at the
// INT32 issue rate.  chip_smoke.py counts them (KEY_OPS, RANK_OPS).  The
// design is the simple one: one block of 256 threads walks the vectors of
// its share, the vector is decoded into shared memory before it is read,
// and no thread block keeps values in registers across the exception
// pass.  Cutting the shared-memory round trip and the shared atomics is
// work for a later change.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "vector.cuh"

namespace {

using alp::AlpVector;
using alp::bad_alp;
using alp::bad_rd;
using alp::grid_for;
using alp::kVector;
using alp::merge_key;
using alp::order_key;
using alp::RdVector;
using alp::umax;
using alp::umin;
using alp::warp_max;
using alp::warp_min;
constexpr int kThreads = 256;
constexpr int kMaxThr = 2048;
constexpr int kMaxRanks = 8;
constexpr unsigned kFull = alp::kFullMask;

// K15's binning, shared with K17.  Thresholds into shared th[E], the
// block's histogram hist[E + 1] zeroed; the caller syncs before use.
template <typename U>
__device__ __forceinline__ void load_bins(U* th, unsigned* hist,
                                          const U* __restrict__ thr, int E) {
  for (int j = threadIdx.x; j < E; j += blockDim.x) th[j] = thr[j];
  for (int j = threadIdx.x; j <= E; j += blockDim.x) hist[j] = 0;
}

// Count one key (none when `real` is false: the pad) at its bin
// #{th < key}.  Every lane of the warp calls it together.
template <typename U>
__device__ __forceinline__ void bin_key(bool real, U key, const U* th, int E,
                                        unsigned* hist) {
  int p = -1;                                // -1: pad, counted nowhere
  if (real) {
    int lo = 0, hi = E;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (th[mid] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    p = lo;
  }
  const unsigned peers = __match_any_sync(kFull, p);
  if (p >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[p], static_cast<unsigned>(__popc(peers)));
}

// The block's nonzero bins into the global int64 bins; after a barrier.
__device__ __forceinline__ void flush_bins(const unsigned* hist, int E,
                                           unsigned long long* bins) {
  for (int j = threadIdx.x; j <= E; j += blockDim.x)
    if (hist[j]) atomicAdd(&bins[j], static_cast<unsigned long long>(hist[j]));
}

// K15: prefix-count bins of the keys of rows 0..n-1 (vector rows[i]).
template <class V>
__global__ void __launch_bounds__(kThreads)
key_counts_kernel(V src, const long long* __restrict__ rows, long long n,
                  long long n_values, const typename V::U* __restrict__ thr,
                  int E, unsigned long long* __restrict__ bins) {
  using U = typename V::U;
  __shared__ typename V::Shared sh;
  __shared__ U vals[kVector];
  __shared__ U th[kMaxThr];
  __shared__ unsigned hist[kMaxThr + 1];
  load_bins(th, hist, thr, E);
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const long long vec = rows[i];
    src.decode(sh, vals, i, vec);            // ends in a barrier
    const long long valid = n_values - vec * kVector;
    for (int k = threadIdx.x; k < kVector; k += kThreads)
      bin_key(k < valid, order_key(vals[k]), th, E, hist);
    __syncthreads();                         // vals is read
  }
  __syncthreads();
  flush_bins(hist, E, bins);
}

// K16: (least key, largest key) of each vector into out[rows[i]].
template <class V>
__global__ void __launch_bounds__(kThreads)
key_extremes_kernel(V src, const long long* __restrict__ rows, long long n,
                    long long n_values, typename V::U* __restrict__ out) {
  using U = typename V::U;
  constexpr int kWarps = kThreads / 32;
  __shared__ typename V::Shared sh;
  __shared__ U vals[kVector];
  __shared__ U wlo[kWarps], whi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const long long vec = rows[i];
    src.decode(sh, vals, i, vec);
    const long long valid = n_values - vec * kVector;
    U lo = static_cast<U>(~U(0)), hi = 0;
    for (int k = threadIdx.x; k < kVector; k += kThreads) {
      if (k < valid) {
        const U key = order_key(vals[k]);
        lo = umin(lo, key);
        hi = umax(hi, key);
      }
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      wlo[warp] = lo;
      whi[warp] = hi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        lo = umin(lo, wlo[w]);
        hi = umax(hi, whi[w]);
      }
      out[vec * 2] = lo;
      out[vec * 2 + 1] = hi;
    }
    __syncthreads();                         // vals and the rows are read
  }
}

// K17: K15's bins of rows 0..n-1 at E thresholds, and for each of the R
// brackets br[2r] <= key <= br[2r + 1] the least and largest key in it,
// merged into mm[2r], mm[2r + 1].
template <class V>
__global__ void __launch_bounds__(kThreads)
rank_pass_kernel(V src, const long long* __restrict__ rows, long long n,
                 long long n_values, const typename V::U* __restrict__ thr,
                 int E, const typename V::U* __restrict__ br, int R,
                 unsigned long long* __restrict__ bins,
                 typename V::U* __restrict__ mm) {
  using U = typename V::U;
  constexpr int kWarps = kThreads / 32;
  __shared__ typename V::Shared sh;
  __shared__ U vals[kVector];
  __shared__ U th[kMaxThr];
  __shared__ unsigned hist[kMaxThr + 1];
  __shared__ U blo[kMaxRanks], bhi[kMaxRanks];
  __shared__ U wlo[kWarps][kMaxRanks], whi[kWarps][kMaxRanks];
  load_bins(th, hist, thr, E);
  if (static_cast<int>(threadIdx.x) < R) {
    blo[threadIdx.x] = br[2 * threadIdx.x];
    bhi[threadIdx.x] = br[2 * threadIdx.x + 1];
  }
  U lo[kMaxRanks], hi[kMaxRanks];
#pragma unroll
  for (int r = 0; r < kMaxRanks; ++r) {
    lo[r] = static_cast<U>(~U(0));
    hi[r] = 0;
  }
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const long long vec = rows[i];
    src.decode(sh, vals, i, vec);            // ends in a barrier
    const long long valid = n_values - vec * kVector;
    for (int k = threadIdx.x; k < kVector; k += kThreads) {
      const bool real = k < valid;
      const U key = order_key(vals[k]);
      bin_key(real, key, th, E, hist);
      if (real) {
#pragma unroll
        for (int r = 0; r < kMaxRanks; ++r) {
          if (r < R && blo[r] <= key && key <= bhi[r]) {
            lo[r] = umin(lo[r], key);
            hi[r] = umax(hi[r], key);
          }
        }
      }
    }
    __syncthreads();                         // vals is read
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kMaxRanks; ++r) {
    if (r < R) {
      const U l = warp_min(lo[r]), h = warp_max(hi[r]);
      if (lane == 0) {
        wlo[warp][r] = l;
        whi[warp][r] = h;
      }
    }
  }
  __syncthreads();
  flush_bins(hist, E, bins);
  if (static_cast<int>(threadIdx.x) < R) {
    const int r = threadIdx.x;
    U l = wlo[0][r], h = whi[0][r];
    for (int w = 1; w < kWarps; ++w) {
      l = umin(l, wlo[w][r]);
      h = umax(h, whi[w][r]);
    }
    if (l <= h) merge_key(mm + 2 * r, l, h);  // else: none in the bracket
  }
}

// Thresholds, bins and out are optional per kernel: E < 0 launches K16.
template <class V>
int launch(const V& src, const void* rows, long long n, long long n_values,
           const void* thr, int E, void* bins, void* out, int dev,
           void* stream) {
  using U = typename V::U;
  if (n < 0 || n_values < 0 || E > kMaxThr || E == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  const auto* r = static_cast<const long long*>(rows);
  const auto s = static_cast<cudaStream_t>(stream);
  if (E > 0) {
    const cudaError_t err =
        grid_for(key_counts_kernel<V>, n, dev, kThreads, 0, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks)
      key_counts_kernel<V><<<blocks, kThreads, 0, s>>>(
          src, r, n, n_values, static_cast<const U*>(thr), E,
          static_cast<unsigned long long*>(bins));
  } else {
    const cudaError_t err =
        grid_for(key_extremes_kernel<V>, n, dev, kThreads, 0, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks)
      key_extremes_kernel<V><<<blocks, kThreads, 0, s>>>(
          src, r, n, n_values, static_cast<U*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// K17 over a bucket: 1 <= E <= kMaxThr thresholds, 1 <= R <= kMaxRanks
// brackets.
template <class V>
int launch_rank(const V& src, const void* rows, long long n,
                long long n_values, const void* thr, int E, const void* br,
                int R, void* bins, void* mm, int dev, void* stream) {
  using U = typename V::U;
  if (n < 0 || n_values < 0 || E < 1 || E > kMaxThr || R < 1 ||
      R > kMaxRanks)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  const cudaError_t err =
      grid_for(rank_pass_kernel<V>, n, dev, kThreads, 0, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    rank_pass_kernel<V><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        src, static_cast<const long long*>(rows), n, n_values,
        static_cast<const U*>(thr), E, static_cast<const U*>(br), R,
        static_cast<unsigned long long*>(bins), static_cast<U*>(mm));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers on card
// `dev`, which the caller has made current.  ALP entries take K1/K2's
// bucket arguments and the plan's ALP exception CSR (exc_bits: true
// bits); RD entries K3/K4's and the RD exception CSR (exc_left: raw left
// parts).  K15 adds into bins (int64 [E + 1]); thr holds E ascending
// unsigned keys (uint64 for f64, uint32 for f32), 1 <= E <= 2048.  K16
// writes out (keys, [n_vectors, 2]) at rows rows[i].  K17 adds into bins
// as K15 and merges into mm (keys, [R, 2]) the least and largest key in
// each bracket of br (keys, [R, 2]: lo, hi), 1 <= R <= 8.  Every entry
// returns cudaGetLastError() (or the error of its device query).

extern "C" int alp_key_counts_alp_f64(ALP_ARGS, const void* thr, int E,
                                      void* bins, int dev, void* stream) {
  if (bad_alp(bw, 64) || E < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ALP_ROUTE(double), rows, n, n_values, thr, E, bins, nullptr,
                dev, stream);
}

extern "C" int alp_key_counts_alp_f32(ALP_ARGS, const void* thr, int E,
                                      void* bins, int dev, void* stream) {
  if (bad_alp(bw, 32) || E < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ALP_ROUTE(float), rows, n, n_values, thr, E, bins, nullptr,
                dev, stream);
}

extern "C" int alp_key_counts_rd_f64(RD_ARGS, const void* thr, int E,
                                     void* bins, int dev, void* stream) {
  if (bad_rd(rbw, lbw, 64) || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(RD_ROUTE(uint64_t, 64), rows, n, n_values, thr, E, bins,
                nullptr, dev, stream);
}

extern "C" int alp_key_counts_rd_f32(RD_ARGS, const void* thr, int E,
                                     void* bins, int dev, void* stream) {
  if (bad_rd(rbw, lbw, 32) || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(RD_ROUTE(uint32_t, 32), rows, n, n_values, thr, E, bins,
                nullptr, dev, stream);
}

extern "C" int alp_key_extremes_alp_f64(ALP_ARGS, void* out, int dev,
                                        void* stream) {
  if (bad_alp(bw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ALP_ROUTE(double), rows, n, n_values, nullptr, -1, nullptr,
                out, dev, stream);
}

extern "C" int alp_key_extremes_alp_f32(ALP_ARGS, void* out, int dev,
                                        void* stream) {
  if (bad_alp(bw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ALP_ROUTE(float), rows, n, n_values, nullptr, -1, nullptr,
                out, dev, stream);
}

extern "C" int alp_key_extremes_rd_f64(RD_ARGS, void* out, int dev,
                                       void* stream) {
  if (bad_rd(rbw, lbw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(RD_ROUTE(uint64_t, 64), rows, n, n_values, nullptr, -1,
                nullptr, out, dev, stream);
}

extern "C" int alp_key_extremes_rd_f32(RD_ARGS, void* out, int dev,
                                       void* stream) {
  if (bad_rd(rbw, lbw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(RD_ROUTE(uint32_t, 32), rows, n, n_values, nullptr, -1,
                nullptr, out, dev, stream);
}

extern "C" int alp_rank_pass_alp_f64(ALP_ARGS, const void* thr, int E,
                                     const void* br, int R, void* bins,
                                     void* mm, int dev, void* stream) {
  if (bad_alp(bw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rank(ALP_ROUTE(double), rows, n, n_values, thr, E, br, R,
                     bins, mm, dev, stream);
}

extern "C" int alp_rank_pass_alp_f32(ALP_ARGS, const void* thr, int E,
                                     const void* br, int R, void* bins,
                                     void* mm, int dev, void* stream) {
  if (bad_alp(bw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rank(ALP_ROUTE(float), rows, n, n_values, thr, E, br, R,
                     bins, mm, dev, stream);
}

extern "C" int alp_rank_pass_rd_f64(RD_ARGS, const void* thr, int E,
                                    const void* br, int R, void* bins,
                                    void* mm, int dev, void* stream) {
  if (bad_rd(rbw, lbw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rank(RD_ROUTE(uint64_t, 64), rows, n, n_values, thr, E, br,
                     R, bins, mm, dev, stream);
}

extern "C" int alp_rank_pass_rd_f32(RD_ARGS, const void* thr, int E,
                                    const void* br, int R, void* bins,
                                    void* mm, int dev, void* stream) {
  if (bad_rd(rbw, lbw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rank(RD_ROUTE(uint32_t, 32), rows, n, n_values, thr, E, br,
                     R, bins, mm, dev, stream);
}
