// One vector of a plan bucket, decoded into shared memory with its true
// exception bits written in, and the IEEE-754 total-order key of a value.
//
// The key kernels K15-K17 (keys.cu) and the grouped kernels K18/K19
// (group.cu) read every value of a vector through one of four routes, ALP
// f64, ALP f32, ALP_RD f64 and ALP_RD f32.  Each route is a struct with
// the bucket's arguments, as K1-K4 take them, and the plan's per-vector
// exception CSR (a compressed row index: vector vec's exceptions are
// entries exc_ptr[vec] .. exc_ptr[vec + 1] of exc_index, their flat
// positions vec * 1024 + k, and of the true bits or left parts).  decode()
// stages the packed words with fastlanes.cuh's stage(), computes K1/K2's
// formula or K3/K4's glue, then overwrites the exception slots, so the
// values are the column's own bits (NaN, +-Inf and -0.0 included).  The
// pad of a partial last vector is left to the caller.  The header also
// holds what those kernels share around the routes: the key helpers, the
// grid size and the C arguments of a bucket (ALP_ARGS, RD_ARGS).
//
// The key of bits b is ~b for a negative value and b | sign otherwise,
// after -0.0 is mapped to +0.0: unsigned order on keys is the total order
// -NaN < -Inf < finite < +Inf < +NaN, with the two zeros equal
// (alp_tpu/engine.py _float_key and _key_from_limbs).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "fastlanes.cuh"

namespace alp {

template <typename U>
__device__ __forceinline__ U order_key(U b) {
  constexpr U kSign = U(1) << (sizeof(U) * 8 - 1);
  if (b == kSign) b = 0;
  return (b & kSign) ? static_cast<U>(~b) : static_cast<U>(b | kSign);
}

constexpr unsigned kFullMask = 0xffffffffu;

// unsigned min / max of any width (uint64_t is unsigned long here)
template <typename U>
__device__ __forceinline__ U umin(U a, U b) { return b < a ? b : a; }
template <typename U>
__device__ __forceinline__ U umax(U a, U b) { return a < b ? b : a; }

template <typename U>
__device__ __forceinline__ U warp_min(U v) {
  for (int o = 16; o; o >>= 1)
    v = umin(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

template <typename U>
__device__ __forceinline__ U warp_max(U v) {
  for (int o = 16; o; o >>= 1)
    v = umax(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// atomicMin / atomicMax of an unsigned key of either width
__device__ __forceinline__ void merge_key(uint64_t* mm, uint64_t lo,
                                          uint64_t hi) {
  auto* p = reinterpret_cast<unsigned long long*>(mm);
  atomicMin(p, static_cast<unsigned long long>(lo));
  atomicMax(p + 1, static_cast<unsigned long long>(hi));
}
__device__ __forceinline__ void merge_key(uint32_t* mm, uint32_t lo,
                                          uint32_t hi) {
  auto* p = reinterpret_cast<unsigned*>(mm);
  atomicMin(p, static_cast<unsigned>(lo));
  atomicMax(p + 1, static_cast<unsigned>(hi));
}

// ALP route (K1/K2's decode).  exc_bits: the exceptions' true bits.
template <typename F>
struct AlpVector {
  using U = typename Num<F>::U;
  static constexpr int S = Num<F>::S;
  struct Shared {
    U words[kVector];                        // bw <= S: at most 1024 words
  };
  const U* packed;
  int bw;
  const U* base;
  const U* fact;
  const F* frac;
  const long long* exc_ptr;
  const long long* exc_index;
  const U* exc_bits;

  // Row i of the bucket, vector `vec` of the column, into vals[1024].
  // Every thread of the block calls it; it returns after a barrier.
  __device__ __forceinline__ void decode(Shared& sh, U* vals, long long i,
                                         long long vec) const {
    stage<U, S>(sh.words, packed + i * bw * (kVector / S), bw);
    __syncthreads();
    const U b0 = base[i], f = fact[i];
    const F fr = frac[i];
    for (int k = threadIdx.x; k < kVector; k += blockDim.x) {
      const U u = bw ? unpack<U, S>(sh.words, bw, k) : U(0);
      vals[k] = Num<F>::bits(Num<F>::decode(static_cast<U>((b0 + u) * f),
                                            fr));
    }
    __syncthreads();
    const long long e1 = exc_ptr[vec + 1];
    for (long long e = exc_ptr[vec] + threadIdx.x; e < e1; e += blockDim.x)
      vals[exc_index[e] & (kVector - 1)] = exc_bits[e];
    __syncthreads();
  }
};

// ALP_RD route (K3/K4's glue).  exc_left: the exceptions' raw left parts,
// placed above the right bits already decoded (DecodePlan.patch_rd).
template <typename U_, int S_>
struct RdVector {
  using U = U_;
  static constexpr int S = S_;
  struct Shared {
    U rwords[kVector];
    uint16_t lwords[kVector];                // lbw <= 16: at most 1024
    U entries[8];
  };
  const U* right;
  int rbw;
  const uint16_t* left;
  int lbw;
  const uint16_t* dict;
  const int* dict_size;
  const long long* exc_ptr;
  const long long* exc_index;
  const long long* exc_left;

  __device__ __forceinline__ void decode(Shared& sh, U* vals, long long i,
                                         long long vec) const {
    stage<U, S>(sh.rwords, right + i * rbw * (kVector / S), rbw);
    stage<uint16_t, 16>(sh.lwords, left + i * lbw * (kVector / 16), lbw);
    if (threadIdx.x < 8) sh.entries[threadIdx.x] = dict[i * 8 + threadIdx.x];
    __syncthreads();
    // indexes past the dictionary (exceptions) take its last entry, as in
    // K3/K4; the exception pass below overwrites those slots
    const int last = max(min(dict_size[i], 8) - 1, 0);
    for (int k = threadIdx.x; k < kVector; k += blockDim.x) {
      const U r = rbw ? unpack<U, S>(sh.rwords, rbw, k) : U(0);
      const int idx = lbw ? unpack<uint16_t, 16>(sh.lwords, lbw, k) : 0;
      const U l = sh.entries[min(idx, last)];
      vals[k] = rbw < S ? static_cast<U>(static_cast<U>(l << rbw) | r) : r;
    }
    __syncthreads();
    const long long e1 = exc_ptr[vec + 1];
    if (rbw < S) {
      const U rmask = static_cast<U>((U(1) << rbw) - U(1));
      for (long long e = exc_ptr[vec] + threadIdx.x; e < e1;
           e += blockDim.x) {
        const int k = static_cast<int>(exc_index[e] & (kVector - 1));
        vals[k] = static_cast<U>(
            static_cast<U>(static_cast<U>(exc_left[e]) << rbw) |
            (vals[k] & rmask));
      }
    }
    __syncthreads();
  }
};

// Blocks for n vectors on card `dev` (the card of the tensors): as many
// blocks of `threads` threads and `dyn` bytes of dynamic shared memory as
// can be resident at once (at most one per vector); each walks its share
// of the vectors.
template <typename K>
cudaError_t grid_for(K kernel, long long n, int dev, int threads, size_t dyn,
                     unsigned* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, dyn);
  const long long cap = max(static_cast<long long>(sms) * per_sm, 1ll);
  *blocks = static_cast<unsigned>(n < cap ? n : cap);
  return err;
}

// The routes of a bucket's C arguments, shared by the kernels that read
// vectors through them (keys.cu, group.cu).
template <typename F>
AlpVector<F> alp_route(const void* packed, int bw, const void* base,
                       const void* fact, const void* frac,
                       const void* exc_ptr, const void* exc_index,
                       const void* exc_bits) {
  using U = typename Num<F>::U;
  return {static_cast<const U*>(packed), bw, static_cast<const U*>(base),
          static_cast<const U*>(fact), static_cast<const F*>(frac),
          static_cast<const long long*>(exc_ptr),
          static_cast<const long long*>(exc_index),
          static_cast<const U*>(exc_bits)};
}

template <typename U, int S>
RdVector<U, S> rd_route(const void* right, int rbw, const void* left,
                        int lbw, const void* dict, const void* dict_size,
                        const void* exc_ptr, const void* exc_index,
                        const void* exc_left) {
  return {static_cast<const U*>(right), rbw,
          static_cast<const uint16_t*>(left), lbw,
          static_cast<const uint16_t*>(dict),
          static_cast<const int*>(dict_size),
          static_cast<const long long*>(exc_ptr),
          static_cast<const long long*>(exc_index),
          static_cast<const long long*>(exc_left)};
}

inline bool bad_alp(int bw, int S) { return bw < 0 || bw > S; }
inline bool bad_rd(int rbw, int lbw, int S) {
  return rbw < 0 || rbw > S || lbw < 0 || lbw > 16;
}

}  // namespace alp

// The C arguments of an ALP bucket (K1/K2's, the rows, the plan's ALP
// exception CSR with the true bits) and of an ALP_RD bucket (K3/K4's, the
// rows, the RD exception CSR with the raw left parts), and their routes.
#define ALP_ARGS                                                          \
  const void *packed, int bw, const void *base, const void *fact,         \
      const void *frac, const void *rows, const void *exc_ptr,            \
      const void *exc_index, const void *exc_bits, long long n,           \
      long long n_values
#define RD_ARGS                                                           \
  const void *right, int rbw, const void *left, int lbw, const void *dict, \
      const void *dict_size, const void *rows, const void *exc_ptr,       \
      const void *exc_index, const void *exc_left, long long n,           \
      long long n_values
#define ALP_ROUTE(F)                                                      \
  alp::alp_route<F>(packed, bw, base, fact, frac, exc_ptr, exc_index,     \
                    exc_bits)
#define RD_ROUTE(U, S)                                                    \
  alp::rd_route<U, S>(right, rbw, left, lbw, dict, dict_size, exc_ptr,    \
                      exc_index, exc_left)
