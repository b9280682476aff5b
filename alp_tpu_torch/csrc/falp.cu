// Hand-written Hopper (sm_90a) decode kernels of alp_tpu_torch.
//
// Four kernels, the whole decode path of an ALPT column:
//
//   K1 alp_falp_f64  replaces the six f64 falp kernels of the JAX package,
//                    alp_tpu/kernels/falp.py: falp_decode_f64 (:143),
//                    falp_decode_f64_mid (:230), _mid64 (:322),
//                    _midc96 (:394), _const (:444) and _small (:1229).
//                    Those six emulate FP64 in 32-bit integer softfloat,
//                    one per bit-width/magnitude class, because the TPU has
//                    no IEEE FP64.  Hopper has it, so one kernel computes
//                    the reference formula for every bit width 0..64:
//                      n = base + u                  (wrapping, unsigned)
//                      m = n * FACT[fac]             (wrapping, unsigned)
//                      v = RN(RN(double(int64 m)) * FRAC[exp])
//   K2 alp_falp_f32  replaces falp_decode_f32 (falp.py:1336): the same in
//                    32 bits, int32 -> float RN, * FRAC RN.
//   K3 alp_rd_f64    replaces rd_decode_dict_f64 (falp.py:1470): unFFOR the
//                    right part at rbw and the dictionary index at lbw,
//                    look the index up in the rowgroup's dictionary (at
//                    most 8 u16 entries) and glue (left << rbw) | right.
//   K4 alp_rd_f32    replaces rd_decode_dict_f32 (falp.py:1530), the same
//                    over 32-bit words; K3 and K4 are one template.
//
// Layout.  Packed words are read as the ALPT format stores them (reference
// FastLanes layout: for S-bit words L = 1024 / S lanes, value k in lane
// k % L at slot k / L, word w of lane i at w * L + i).  Each launch covers
// one bucket of vectors that share a bit width, passed at run time; the
// unpack is one code path for every width, not 65 instantiations, so the
// build stays at seconds.  Values are written in final order, straight
// into row rows[v] of the column's output.  Exceptions are not touched
// here: the caller scatters their bits afterwards (decoder.hpp:141-149),
// so NaN, +-Inf and -0.0 never come from the formula.
//
// Bound.  Decode moves bytes and does almost no arithmetic: per vector it
// reads bw * 128 bytes of packed words (f64; bw * 128 for f32 too, 32-bit
// words) and 32 bytes of metadata, and writes 8 KiB (f64) or 4 KiB (f32)
// of values.  At 3.35 TB/s a 256 MiB f64 decode cannot take less than
// ~80 us plus its packed input; one FP64 multiply per value is ~2 us of
// the card's FP64 rate.  The design is the simple one for a memory-bound
// pass: one block per vector, the vector's packed words staged once into
// shared memory with coalesced loads, then each thread extracts values
// k, k + 256, ... so that the stores of a warp are contiguous.
//
// Arithmetic.  The unpack and the decode formula are fastlanes.cuh's,
// shared with K7/K8 (exact_sum.cu); the build passes no fast-math or
// flush-to-zero flag, so subnormals survive.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "fastlanes.cuh"

namespace {

using alp::kVector;
using alp::Num;
using alp::stage;
using alp::unpack;
constexpr int kThreads = 256;

// K1 / K2: fused unFFOR + falp, one block per vector.
template <typename F>
__global__ void __launch_bounds__(kThreads)
falp_kernel(const typename Num<F>::U* __restrict__ packed, int bw,
            const typename Num<F>::U* __restrict__ base,
            const typename Num<F>::U* __restrict__ fact,
            const F* __restrict__ frac, const long long* __restrict__ rows,
            F* __restrict__ out) {
  using U = typename Num<F>::U;
  constexpr int S = Num<F>::S;
  __shared__ U words[kVector];               // bw <= S: at most 1024 words
  const long long vec = blockIdx.x;
  stage<U, S>(words, packed + vec * bw * (kVector / S), bw);
  __syncthreads();
  const U b = base[vec], f = fact[vec];
  const F fr = frac[vec];
  F* dst = out + (rows ? rows[vec] : vec) * kVector;
  for (int k = threadIdx.x; k < kVector; k += kThreads) {
    const U u = bw ? unpack<U, S>(words, bw, k) : U(0);
    dst[k] = Num<F>::decode(static_cast<U>((b + u) * f), fr);
  }
}

// K3 / K4: ALP_RD glue, one block per vector.  Indexes past the
// dictionary (exceptions) are clamped to its last entry, as the host
// decode does; the exception scatter overwrites them afterwards.
template <typename U, int S>
__global__ void __launch_bounds__(kThreads)
rd_kernel(const U* __restrict__ right, int rbw,
          const uint16_t* __restrict__ left, int lbw,
          const uint16_t* __restrict__ dict,
          const int* __restrict__ dict_size,
          const long long* __restrict__ rows, U* __restrict__ out) {
  __shared__ U rwords[kVector];
  __shared__ uint16_t lwords[kVector];       // lbw <= 16: at most 1024
  __shared__ U entries[8];
  const long long vec = blockIdx.x;
  stage<U, S>(rwords, right + vec * rbw * (kVector / S), rbw);
  stage<uint16_t, 16>(lwords, left + vec * lbw * (kVector / 16), lbw);
  if (threadIdx.x < 8) entries[threadIdx.x] = dict[vec * 8 + threadIdx.x];
  __syncthreads();
  const int last = max(min(dict_size[vec], 8) - 1, 0);
  U* dst = out + (rows ? rows[vec] : vec) * kVector;
  for (int k = threadIdx.x; k < kVector; k += kThreads) {
    const U r = rbw ? unpack<U, S>(rwords, rbw, k) : U(0);
    const int idx = lbw ? unpack<uint16_t, 16>(lwords, lbw, k) : 0;
    const U l = entries[min(idx, last)];
    dst[k] = rbw < S ? static_cast<U>(static_cast<U>(l << rbw) | r) : r;
  }
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers; rows may
// be null (vector v -> row v).  Every entry returns cudaGetLastError().

extern "C" int alp_falp_f64(const void* packed, int bw, const void* base,
                            const void* fact, const void* frac,
                            const void* rows, void* out, long long n,
                            void* stream) {
  if (n < 0 || n > INT_MAX || bw < 0 || bw > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    falp_kernel<double><<<static_cast<unsigned>(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(packed), bw,
        static_cast<const uint64_t*>(base),
        static_cast<const uint64_t*>(fact),
        static_cast<const double*>(frac),
        static_cast<const long long*>(rows), static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int alp_falp_f32(const void* packed, int bw, const void* base,
                            const void* fact, const void* frac,
                            const void* rows, void* out, long long n,
                            void* stream) {
  if (n < 0 || n > INT_MAX || bw < 0 || bw > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    falp_kernel<float><<<static_cast<unsigned>(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), bw,
        static_cast<const uint32_t*>(base),
        static_cast<const uint32_t*>(fact),
        static_cast<const float*>(frac),
        static_cast<const long long*>(rows), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename U, int S>
static int launch_rd(const void* right, int rbw, const void* left, int lbw,
                     const void* dict, const void* dict_size,
                     const void* rows, void* out, long long n,
                     void* stream) {
  if (n < 0 || n > INT_MAX || rbw < 0 || rbw > S || lbw < 0 || lbw > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    rd_kernel<U, S><<<static_cast<unsigned>(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const U*>(right), rbw,
        static_cast<const uint16_t*>(left), lbw,
        static_cast<const uint16_t*>(dict),
        static_cast<const int*>(dict_size),
        static_cast<const long long*>(rows), static_cast<U*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int alp_rd_f64(const void* right, int rbw, const void* left,
                          int lbw, const void* dict, const void* dict_size,
                          const void* rows, void* out, long long n,
                          void* stream) {
  return launch_rd<uint64_t, 64>(right, rbw, left, lbw, dict, dict_size,
                                 rows, out, n, stream);
}

extern "C" int alp_rd_f32(const void* right, int rbw, const void* left,
                          int lbw, const void* dict, const void* dict_size,
                          const void* rows, void* out, long long n,
                          void* stream) {
  return launch_rd<uint32_t, 32>(right, rbw, left, lbw, dict, dict_size,
                                 rows, out, n, stream);
}
