// One vector of a plan bucket, decoded into shared memory with its true
// exception bits written in, and the IEEE-754 total-order key of a value.
//
// The key kernels K15/K16 (keys.cu) read every value of a vector through
// one of four routes, ALP f64, ALP f32, ALP_RD f64 and ALP_RD f32.  Each
// route is a struct with the bucket's arguments, as K1-K4 take them, and
// the plan's per-vector exception CSR (a compressed row index: vector
// vec's exceptions are entries exc_ptr[vec] .. exc_ptr[vec + 1] of
// exc_index, their flat positions vec * 1024 + k, and of the true bits or
// left parts).  decode() stages the packed words with fastlanes.cuh's
// stage(), computes K1/K2's formula or K3/K4's glue, then overwrites the
// exception slots, so the values are the column's own bits (NaN, +-Inf and
// -0.0 included).  The pad of a partial last vector is left to the caller.
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

}  // namespace alp
