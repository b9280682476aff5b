// Device helpers shared by the port's kernels: the FastLanes unpack of one
// vector's packed words, their staging into shared memory, and the ALP
// decode formula.  The decode kernels K1/K2 (falp.cu) and the fused
// decode + exact-SUM kernels K7/K8 (exact_sum.cu) decode with these same
// lines, so a value summed by K7 has the bits K1 writes.
//
// Layout (reference FastLanes layout): for S-bit words a 1024-value
// vector has L = 1024 / S lanes; value k lives in lane k % L at slot
// k / L, and word w of lane i is stored at w * L + i.
//
// Arithmetic: integer products run in unsigned types (signed overflow is
// undefined in C++); the conversion and the multiply use the _rn
// intrinsics, which nvcc never contracts into an FMA.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace alp {

constexpr int kVector = 1024;

// Bits [slot * bw, (slot + 1) * bw) of value k's lane, 0 < bw <= S.
template <typename W, int S>
__device__ __forceinline__ W unpack(const W* w, int bw, int k) {
  constexpr int L = kVector / S;
  const int lane = k % L, slot = k / L;
  const int off = slot * bw, w0 = off / S, s0 = off % S;
  W u = static_cast<W>(w[w0 * L + lane] >> s0);
  if (s0 + bw > S) u |= static_cast<W>(w[(w0 + 1) * L + lane] << (S - s0));
  return bw >= S ? u : static_cast<W>(u & ((W(1) << bw) - W(1)));
}

// One vector's bw * L packed words, global -> shared, coalesced.
template <typename W, int S>
__device__ __forceinline__ void stage(W* sh, const W* src, int bw) {
  const int nw = bw * (kVector / S);
  for (int j = threadIdx.x; j < nw; j += blockDim.x) sh[j] = src[j];
}

// decode(m, frac) = RN(RN(float(signed m)) * frac); bits() reinterprets.
template <typename F> struct Num;
template <> struct Num<double> {
  using U = uint64_t;
  static constexpr int S = 64;
  static __device__ __forceinline__ double decode(U m, double frac) {
    return __dmul_rn(__ll2double_rn(static_cast<long long>(m)), frac);
  }
  static __device__ __forceinline__ U bits(double v) {
    return static_cast<U>(__double_as_longlong(v));
  }
};
template <> struct Num<float> {
  using U = uint32_t;
  static constexpr int S = 32;
  static __device__ __forceinline__ float decode(U m, float frac) {
    return __fmul_rn(__int2float_rn(static_cast<int>(m)), frac);
  }
  static __device__ __forceinline__ U bits(float v) {
    return static_cast<U>(__float_as_uint(v));
  }
};

}  // namespace alp
