// Hand-written Hopper (sm_90a) grouped kernels of alp_tpu_torch: GROUP-BY
// and the windowed aggregates over a compressed column.
//
//   K18 vector_sum_extremes  replaces sum_extremes_planes_f64
//                            (alp_tpu/kernels/falp.py:2046): for each
//                            vector, its exact-SUM totals and its least and
//                            largest total-order key, fused with the decode.
//   K19 group_reduce         no TPU site: the counterpart of the XLA grouped
//                            passes of alp_tpu/engine.py (the one-hot MXU
//                            pass _mxu_scan and the segment_sum chunks
//                            _groupby_chunk_f64/_f32).  The exact-SUM totals,
//                            the row count and the least and largest key of
//                            every group, fused with the decode.
//
// Both are one template over the four routes of vector.cuh (ALP f64, ALP
// f32, ALP_RD f64, ALP_RD f32), so eight C entries.  Each decodes a vector
// of its bucket into shared memory with its true exception bits written in
// (vector.cuh), skips the pad of a partial last vector and adds each
// value's signed 32-bit digits in digits.cuh's window layout: W windows
// over the whole exponent range (W = 66 for f64, 9 for f32), then the
// counts of NaN, +Inf and -Inf.  Integer sums are exact in any order, so
// both equal their plain versions exactly (tolerance 0).
//
// K18.  What site 33 computes per lane column of 8 vectors (16-bit digit
// halves in i32 over a static 4-window envelope, an out-of-envelope count,
// biased i32 key words), reduced per vector by the XLA code after it
// (alp_tpu/engine.py:2573-2601), is what K18 writes per vector: the int64
// row [W + 3] of vector rows[i] into sums[rows[i]] and its (least, largest)
// key into keys[rows[i]].  Every value lands in its window, so there is no
// envelope and no out-of-envelope row.  One block of 256 threads a vector
// (a grid stride over the bucket): digits.cuh's Acc sums the block's 1024
// values into a shared row, a warp and a block reduction take the keys'
// extremes, and the block stores the row and the pair: no global atomics.
//
// K19.  keys[i * 1024 + k] is the group id of value k of row i; an id
// outside [0, G) is not counted (the engine checks the keys first).  The
// output is out[G, W + 4] (the windows, the three special counts and the
// row count, int64) and ext[G, 2] (the least and largest key, merged by
// atomicMin / atomicMax; the caller starts each pair at (all ones, 0), so a
// group that no value reaches keeps it).  The 32 lanes of a warp take 32
// values at once and merge the runs of equal (group, window, sign) with
// __match_any_sync, as K15 merges equal bins: each run's digits are summed
// as 16-bit halves with __reduce_add_sync and its first lane adds them with
// one atomic a digit; a second match on the group alone gives the row
// count and, with __reduce_min/max_sync, the keys' extremes.  Ordered keys
// and windows give runs of 32, random keys at large G runs of 1.  While
// G * ((W + 4) * 8 + 2 * key bytes) fits in kSharedAcc bytes (f64: 355
// groups, f32: 1828) each block accumulates in shared memory and adds its
// nonzero entries to the global output once at the end; above that the
// atomics go straight to device memory.  A group of 2^31 values or more
// could overflow an int64 window: one K19 call sums fewer than 2^31
// values (the wrappers check), and the engine sums longer columns in runs;
// K18's rows hold one vector each and take any number of vectors.
//
// K23 key_extremes_bits_f64 replaces key_extremes_planes_f64
// (alp_tpu/kernels/falp.py:1998), the key half of site 33 over decoded
// bits: each vector's least and largest total-order key (order_key, -0.0
// folded onto +0.0, as _key_words_f64 does), every one of its 1024 values
// read (the TPU kernel has no pad either), as uint64 [n, 2].  Site 32's
// biased i32 words per lane column of 8 vectors are a layout of the TPU;
// what the grouped aggregates read is the vector's pair.  It is bound by
// bytes (8 read a value, 16 written a vector): one block of 256 threads a
// vector, 4 coalesced loads a thread, a warp and a block reduction.
//
// Bound.  K18 and K19 read only the packed words, the metadata, the row ids and
// the exceptions of their vectors (a few bits a value), K19 also 4 bytes
// of group id a value, and write a few hundred bytes a vector (K18) or
// group (K19).  The work is the exact sum's (chip_smoke.py's SUM_OPS) plus
// the decode and the key (KEY_OPS) and two compares a value, at the INT32
// issue rate: both are bound by operations.  The matches, reductions and
// atomics above are the design's cost, not the function's.

#include <cstdint>
#include <cuda_runtime.h>

#include "digits.cuh"
#include "vector.cuh"

namespace {

using alp::Acc;
using alp::atomic_add;
using alp::bad_alp;
using alp::bad_rd;
using alp::Fixed;
using alp::grid_for;
using alp::kVector;
using alp::merge_key;
using alp::order_key;
using alp::umax;
using alp::umin;
using alp::warp_max;
using alp::warp_min;
using alp::zero_row;
constexpr int kThreads = alp::kAccThreads;
constexpr int kPer = alp::kAccPer;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = alp::kFullMask;
constexpr size_t kSharedAcc = 200 * 1024;   // K19's per-block accumulators
constexpr int kMaxGroups = 1 << 24;         // a group id fills 24 bits

// K18: the exact-SUM row and the key extremes of each vector.
template <class V>
__global__ void __launch_bounds__(kThreads)
vector_sums_kernel(V src, const long long* __restrict__ rows, long long n,
                   long long n_values, long long* __restrict__ sums,
                   typename V::U* __restrict__ keys) {
  using U = typename V::U;
  constexpr int kRow = Fixed<U>::W + 3;
  __shared__ typename V::Shared sh;
  __shared__ U vals[kVector];
  __shared__ long long row[kRow];
  __shared__ U wlo[kWarps], whi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  zero_row<U>(row);
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const long long vec = rows[i];
    src.decode(sh, vals, i, vec);            // ends in a barrier
    const long long valid = n_values - vec * kVector;
    U b[kPer];
    bool ok[kPer];
    U lo = static_cast<U>(~U(0)), hi = 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int k = threadIdx.x + r * kThreads;
      b[r] = vals[k];
      ok[r] = k < valid;
      if (ok[r]) {
        const U key = order_key(b[r]);
        lo = umin(lo, key);
        hi = umax(hi, key);
      }
    }
    Acc<U> acc(row);
    acc.add(b, ok);
    acc.settle();
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      wlo[warp] = lo;
      whi[warp] = hi;
    }
    __syncthreads();                         // the row and the keys are in
    for (int j = threadIdx.x; j < kRow; j += kThreads) {
      sums[vec * kRow + j] = row[j];
      row[j] = 0;
    }
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        lo = umin(lo, wlo[w]);
        hi = umax(hi, whi[w]);
      }
      keys[vec * 2] = lo;
      keys[vec * 2 + 1] = hi;
    }
    __syncthreads();                         // vals, row and wlo/whi are read
  }
}

// The least and the largest key among the lanes of `peers` (each lane of
// the mask calls it with the same mask).
__device__ __forceinline__ void peer_extremes(unsigned peers, uint64_t key,
                                              uint64_t& lo, uint64_t& hi) {
  const unsigned kh = static_cast<unsigned>(key >> 32);
  const unsigned kl = static_cast<unsigned>(key);
  const unsigned mh = __reduce_min_sync(peers, kh);
  const unsigned ml = __reduce_min_sync(peers, kh == mh ? kl : 0xffffffffu);
  const unsigned xh = __reduce_max_sync(peers, kh);
  const unsigned xl = __reduce_max_sync(peers, kh == xh ? kl : 0u);
  lo = (static_cast<uint64_t>(mh) << 32) | ml;
  hi = (static_cast<uint64_t>(xh) << 32) | xl;
}
__device__ __forceinline__ void peer_extremes(unsigned peers, uint32_t key,
                                              uint32_t& lo, uint32_t& hi) {
  lo = __reduce_min_sync(peers, key);
  hi = __reduce_max_sync(peers, key);
}

// One value a lane into the group accumulators acc [G, W + 4] and kx
// [G, 2]; g < 0 for a lane without a value.  Every lane of the warp calls
// it together.
template <typename U>
__device__ __forceinline__ void add_grouped(int g, U b, long long* acc,
                                            U* kx) {
  using Fx = Fixed<U>;
  constexpr int kCols = Fx::W + 4;
  const int lane = threadIdx.x & 31;
  const bool real = g >= 0;
  const Fx x(b);
  // runs of equal (group, code): code 2j + sign for a nonzero finite
  // value (j < 64), 128 + class for NaN / +Inf / -Inf, 254 for a zero and
  // 255 for a lane without a value
  const unsigned code = !real ? 255u
                        : x.cls ? 128u + x.cls
                        : x.j < 0 ? 254u
                                  : 2u * x.j + (x.neg ? 1u : 0u);
  const unsigned gid = real ? static_cast<unsigned>(g) : 0xffffffu;
  const unsigned peers = __match_any_sync(kFull, (gid << 8) | code);
  const bool lead = lane == __ffs(peers) - 1;
  long long* grow = acc + static_cast<long long>(real ? g : 0) * kCols;
#pragma unroll
  for (int p = 0; p < Fx::P; ++p) {
    const uint32_t d = code < 128 ? x.d[p] : 0u;
    const unsigned lo = __reduce_add_sync(peers, d & 0xffffu);
    const unsigned hi = __reduce_add_sync(peers, d >> 16);
    const long long s = static_cast<long long>(lo) +
                        (static_cast<long long>(hi) << 16);
    if (lead && code < 128 && s) atomic_add(&grow[x.j + p], x.neg ? -s : s);
  }
  if (lead && code > 128 && code < 132)
    atomic_add(&grow[Fx::W + x.cls - 1], __popc(peers));
  const unsigned gpeers =
      __match_any_sync(kFull, real ? static_cast<unsigned>(g) : 0xffffffffu);
  U lo, hi;
  peer_extremes(gpeers, order_key(b), lo, hi);
  if (real && lane == __ffs(gpeers) - 1) {
    atomic_add(&grow[Fx::W + 3], __popc(gpeers));
    merge_key(kx + 2 * static_cast<long long>(g), lo, hi);
  }
}

// K19: the groups' totals, counts and key extremes of rows 0..n-1; in
// shared memory (dynamic, G * (W + 4) int64 then G * 2 keys) when
// `in_shared`, else straight into out / ext.
template <class V>
__global__ void __launch_bounds__(kThreads)
group_reduce_kernel(V src, const long long* __restrict__ rows, long long n,
                    long long n_values, const int* __restrict__ gkeys, int G,
                    bool in_shared, long long* __restrict__ out,
                    typename V::U* __restrict__ ext) {
  using U = typename V::U;
  constexpr long long kCols = Fixed<U>::W + 4;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ typename V::Shared sh;
  __shared__ U vals[kVector];
  long long* acc = out;
  U* kx = ext;
  if (in_shared) {
    acc = reinterpret_cast<long long*>(dyn);
    kx = reinterpret_cast<U*>(acc + G * kCols);
    for (long long j = threadIdx.x; j < G * kCols; j += kThreads) acc[j] = 0;
    for (int g = threadIdx.x; g < G; g += kThreads) {
      kx[2 * g] = static_cast<U>(~U(0));
      kx[2 * g + 1] = 0;
    }
    __syncthreads();
  }
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const long long vec = rows[i];
    src.decode(sh, vals, i, vec);            // ends in a barrier
    const long long valid = n_values - vec * kVector;
    for (int k = threadIdx.x; k < kVector; k += kThreads) {
      int g = -1;
      if (k < valid) {
        g = gkeys[i * kVector + k];
        if (g >= G) g = -1;
      }
      add_grouped(g, vals[k], acc, kx);
    }
    __syncthreads();                         // vals is read
  }
  if (in_shared) {
    __syncthreads();
    for (long long j = threadIdx.x; j < G * kCols; j += kThreads)
      if (acc[j]) atomic_add(&out[j], acc[j]);
    for (int g = threadIdx.x; g < G; g += kThreads)
      if (kx[2 * g] <= kx[2 * g + 1])
        merge_key(ext + 2 * g, kx[2 * g], kx[2 * g + 1]);
  }
}

// A call sums fewer than 2^31 values (n rows of 1024).
bool bad_size(long long n, long long n_values) {
  return n < 0 || n * kVector >= (1ll << 31) || n_values < 0;
}

template <class V>
int launch_sums(const V& src, const void* rows, long long n,
                long long n_values, void* sums, void* keys, int dev,
                void* stream) {
  using U = typename V::U;
  // each row holds one vector's totals: no call size can overflow them
  if (n < 0 || n_values < 0) return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  const cudaError_t err =
      grid_for(vector_sums_kernel<V>, n, dev, kThreads, 0, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    vector_sums_kernel<V><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        src, static_cast<const long long*>(rows), n, n_values,
        static_cast<long long*>(sums), static_cast<U*>(keys));
  return static_cast<int>(cudaGetLastError());
}

template <class V>
int launch_group(const V& src, const void* rows, long long n,
                 long long n_values, const void* gkeys, int G, void* out,
                 void* ext, int dev, void* stream) {
  using U = typename V::U;
  if (bad_size(n, n_values) || G < 1 || G > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes =
      static_cast<size_t>(G) * ((Fixed<U>::W + 4) * 8 + 2 * sizeof(U));
  const bool in_shared = bytes <= kSharedAcc;
  const size_t dyn = in_shared ? bytes : 0;
  cudaError_t err = cudaFuncSetAttribute(
      group_reduce_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = grid_for(group_reduce_kernel<V>, n, dev, kThreads, dyn, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    group_reduce_kernel<V><<<blocks, kThreads, dyn,
                             static_cast<cudaStream_t>(stream)>>>(
        src, static_cast<const long long*>(rows), n, n_values,
        static_cast<const int*>(gkeys), G, in_shared,
        static_cast<long long*>(out), static_cast<U*>(ext));
  return static_cast<int>(cudaGetLastError());
}

// K23: one block a vector, a grid stride over the vectors.
__global__ void __launch_bounds__(kThreads)
key_extremes_bits_kernel(const uint64_t* __restrict__ bits, long long n,
                         uint64_t* __restrict__ keys) {
  __shared__ uint64_t wlo[kWarps], whi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long v = blockIdx.x; v < n; v += gridDim.x) {
    uint64_t lo = ~uint64_t(0), hi = 0;
    for (int k = threadIdx.x; k < kVector; k += kThreads) {
      const uint64_t key = order_key(bits[v * kVector + k]);
      lo = umin(lo, key);
      hi = umax(hi, key);
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
      keys[v * 2] = lo;
      keys[v * 2 + 1] = hi;
    }
    __syncthreads();                         // wlo/whi are read
  }
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers on card
// `dev`, which the caller has made current.  ALP entries take K1/K2's
// bucket arguments and the plan's ALP exception CSR (exc_bits: true
// bits); RD entries K3/K4's and the RD exception CSR (exc_left: raw left
// parts).  K18 writes sums (int64 [n_vectors, W + 3]) and keys (keys,
// [n_vectors, 2]) at rows rows[i].  K19 reads gkeys (int32 [n, 1024], the
// group id of every value of row i), 1 <= G <= 2^24, and adds into out
// (int64 [G, W + 4]) and merges into ext (keys, [G, 2]).  Every entry
// returns cudaGetLastError() (or the error of its device query).

extern "C" int alp_vector_sums_alp_f64(ALP_ARGS, void* sums, void* keys,
                                       int dev, void* stream) {
  if (bad_alp(bw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sums(ALP_ROUTE(double), rows, n, n_values, sums, keys, dev,
                     stream);
}

extern "C" int alp_vector_sums_alp_f32(ALP_ARGS, void* sums, void* keys,
                                       int dev, void* stream) {
  if (bad_alp(bw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sums(ALP_ROUTE(float), rows, n, n_values, sums, keys, dev,
                     stream);
}

extern "C" int alp_vector_sums_rd_f64(RD_ARGS, void* sums, void* keys,
                                      int dev, void* stream) {
  if (bad_rd(rbw, lbw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sums(RD_ROUTE(uint64_t, 64), rows, n, n_values, sums, keys,
                     dev, stream);
}

extern "C" int alp_vector_sums_rd_f32(RD_ARGS, void* sums, void* keys,
                                      int dev, void* stream) {
  if (bad_rd(rbw, lbw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sums(RD_ROUTE(uint32_t, 32), rows, n, n_values, sums, keys,
                     dev, stream);
}

extern "C" int alp_group_reduce_alp_f64(ALP_ARGS, const void* gkeys, int G,
                                        void* out, void* ext, int dev,
                                        void* stream) {
  if (bad_alp(bw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_group(ALP_ROUTE(double), rows, n, n_values, gkeys, G, out,
                      ext, dev, stream);
}

extern "C" int alp_group_reduce_alp_f32(ALP_ARGS, const void* gkeys, int G,
                                        void* out, void* ext, int dev,
                                        void* stream) {
  if (bad_alp(bw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_group(ALP_ROUTE(float), rows, n, n_values, gkeys, G, out,
                      ext, dev, stream);
}

extern "C" int alp_group_reduce_rd_f64(RD_ARGS, const void* gkeys, int G,
                                       void* out, void* ext, int dev,
                                       void* stream) {
  if (bad_rd(rbw, lbw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_group(RD_ROUTE(uint64_t, 64), rows, n, n_values, gkeys, G,
                      out, ext, dev, stream);
}

extern "C" int alp_group_reduce_rd_f32(RD_ARGS, const void* gkeys, int G,
                                       void* out, void* ext, int dev,
                                       void* stream) {
  if (bad_rd(rbw, lbw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_group(RD_ROUTE(uint32_t, 32), rows, n, n_values, gkeys, G,
                      out, ext, dev, stream);
}

// K23.  bits: uint64 [n, 1024] decoded f64 bit patterns; keys: uint64
// [n, 2] (least, largest) unsigned keys.
extern "C" int alp_key_extremes_bits_f64(const void* bits, long long n,
                                         void* keys, int dev, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  cudaError_t err = grid_for(key_extremes_bits_kernel, n, dev, kThreads, 0,
                             &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0)
    key_extremes_bits_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(bits), n, static_cast<uint64_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}
