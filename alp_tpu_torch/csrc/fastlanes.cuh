// Device helpers shared by the port's kernels: the FastLanes unpack of one
// vector's packed words and its inverse, the pack of one word, a lane's
// fields read as a stream (K20, K7/K8), their staging into shared memory,
// and the ALP decode formula.  The decode kernels K1/K2 (falp.cu) and the
// fused decode + exact-SUM kernels K7/K8 (exact_sum.cu) decode with these
// same lines, so a value summed by K7 has the bits K1 writes; the pack
// kernel K10 (ffor.cu) places each value with the same slot_pos that
// unpack reads it with.
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

// Where slot `slot` of a lane lives at bit width bw: bits [slot * bw,
// (slot + 1) * bw) of the lane's stream, i.e. from bit s0 of word w0 on
// (spilling into word w0 + 1 when s0 + bw > S).
template <int S>
__device__ __forceinline__ void slot_pos(int bw, int slot, int& w0,
                                         int& s0) {
  const int off = slot * bw;
  w0 = off / S;
  s0 = off % S;
}

// Bits [slot * bw, (slot + 1) * bw) of value k's lane, 0 < bw <= S.
template <typename W, int S>
__device__ __forceinline__ W unpack(const W* w, int bw, int k) {
  constexpr int L = kVector / S;
  const int lane = k % L, slot = k / L;
  int w0, s0;
  slot_pos<S>(bw, slot, w0, s0);
  W u = static_cast<W>(w[w0 * L + lane] >> s0);
  if (s0 + bw > S) u |= static_cast<W>(w[(w0 + 1) * L + lane] << (S - s0));
  return bw >= S ? u : static_cast<W>(u & ((W(1) << bw) - W(1)));
}

// The inverse of unpack: word w of lane `lane` of a vector packed at bit
// width bw (0 < bw <= S), from the vector's values `vals` [1024] in value
// order, each already reduced to its low bw bits.  The word holds the
// slots whose bits meet [w * S, (w + 1) * S): the first may start in word
// w - 1 and spill into w.
template <typename W, int S>
__device__ __forceinline__ W pack_word(const W* vals, int bw, int w,
                                       int lane) {
  constexpr int L = kVector / S;
  const int first = (w * S) / bw;
  const int last = min(S - 1, (w * S + S - 1) / bw);
  W acc = 0;
  for (int slot = first; slot <= last; ++slot) {
    int w0, s0;
    slot_pos<S>(bw, slot, w0, s0);
    const W d = vals[slot * L + lane];
    acc |= w0 == w ? static_cast<W>(d << s0) : static_cast<W>(d >> (S - s0));
  }
  return acc;
}

// Bits [s, s + 64) of the 128-bit word hi:lo, 0 <= s < 64, by two 32-bit
// funnel shifts.
__device__ __forceinline__ uint64_t funnel_r(uint64_t lo, uint64_t hi,
                                             int s) {
  const uint32_t l0 = static_cast<uint32_t>(lo);
  const uint32_t l1 = static_cast<uint32_t>(lo >> 32);
  const uint32_t h0 = static_cast<uint32_t>(hi);
  const uint32_t h1 = static_cast<uint32_t>(hi >> 32);
  const bool up = s >= 32;
  const uint32_t a = up ? l1 : l0, b = up ? h0 : l1, c = up ? h1 : h0;
  return (static_cast<uint64_t>(__funnelshift_r(b, c, s)) << 32) |
         __funnelshift_r(a, b, s);
}

// Bits [s, s + 32) of the 64-bit word hi:lo, 0 <= s < 32.
__device__ __forceinline__ uint32_t funnel_r(uint32_t lo, uint32_t hi,
                                             int s) {
  return __funnelshift_r(lo, hi, s);
}

// Bits [s, s + 16) of the 32-bit word hi:lo, 0 <= s < 16 (the ALP_RD
// dictionary indexes, K3/K4).
__device__ __forceinline__ uint16_t funnel_r(uint16_t lo, uint16_t hi,
                                             int s) {
  return static_cast<uint16_t>((static_cast<uint32_t>(hi) << 16 | lo) >> s);
}

// The bw-bit fields of one lane of S-bit words (W = uint64_t, uint32_t or
// uint16_t),
// slot 0, 1, ... in order, read as a stream (0 <= bw <= S): the thread
// holds the current word and the next (a field may spill into it) and one
// more ahead, and loads each of the lane's bw words once, two words before
// the field that first needs it; next() takes a field with a funnel shift
// and the mask, moves the bit offset by bw and rotates the words where it
// passes S (the same for every lane of a warp).  No divide, no per-slot
// address and no word loaded twice, where unpack() pays all three for every
// value.  At bw = 0 it loads nothing and every field is 0.  `lane` points
// at the lane's word 0 (its word w at lane[w * L]).  K20 (falp.cu), K7/K8
// (exact_sum.cu) and K3/K4 (falp.cu, both parts) read their words with it.
template <typename W>
struct LaneStream {
  static constexpr int S = 8 * sizeof(W);
  static constexpr int L = kVector / S;
  const W* lane;
  int bw, off, at;                           // at: the word in `ahead`
  W cur, nxt, ahead, mask;

  LaneStream() = default;
  __device__ __forceinline__ LaneStream(const W* words, int width)
      : lane(words), bw(width), off(0), at(2) {
    cur = bw > 0 ? lane[0] : W(0);
    nxt = bw > 1 ? lane[L] : W(0);
    ahead = bw > 2 ? lane[2 * L] : W(0);
    mask = bw >= S ? static_cast<W>(~W(0)) : static_cast<W>((W(1) << bw) - 1);
  }

  __device__ __forceinline__ W next() {
    const W u = funnel_r(cur, nxt, off) & mask;
    off += bw;
    if (off >= S) {
      off -= S;
      cur = nxt;
      nxt = ahead;
      ++at;
      ahead = at < bw ? lane[at * L] : W(0);
    }
    return u;
  }
};

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
