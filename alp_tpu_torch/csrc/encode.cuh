// The ALP encode of one value and its decode-verify, in both precisions,
// shared by the encode kernels K9/K12 (encode.cu) and the (e, f) scorers
// K11/K14 (score.cu), so the search and the encode cannot drift apart.
// The decode is fastlanes.cuh's Num<F>::decode, the one K1/K2 decode with.
// Alp<double> and Alp<float> hold each precision's types, tables and the
// two functions below; the kernels are templates over them.
//
// The reference is the host engine (native/alpcore.cpp; encoder.hpp:82-106,
// 307-400, and its float instantiation, alpcore.cpp:625-745), whose blobs
// the port's must equal byte for byte:
//
//   scale   s = RN(RN(v * 10^e) * 10^-f)                (two products)
//   round   r = RN(RN(s + MAGIC) - MAGIC)     (MAGIC = 2^52+2^51 / 2^23+2^22)
//   cast    n = trunc(r) if -2^(W-1) <= r < 2^(W-1), else INT<W>_MIN
//                              (x86 cvttsd2si / cvttss2si; NaN -> INT_MIN)
//   decode  d = RN(RN(float(int<W>(uint<W>(n) * FACT[f]))) * 10^-e)
//
// Every operation is an _rn intrinsic, which nvcc never contracts into an
// FMA (its default would fuse the magic round's add into the product); the
// cast tests the range first, because __double2ll_rz / __float2int_rz
// saturate and map NaN to 0 where x86 writes INT_MIN.  The build passes no
// fast-math or flush-to-zero flag: Hopper's FP64 and FP32 keep subnormals,
// so subnormal inputs (and, in f64, |s| in [2^52, 2^104)) are computed
// exactly here, where the TPU kernels flag them "rare" for the host.
//
// Two checks per precision, as in the reference:
//   encode (K9/K12, encode_simdized): NaN, +-Inf and -0.0 are replaced by
//     ENCODING_UPPER_LIMIT first; a value is an exception when its decode
//     differs from the replaced value.  f64 compares bits, f32 floats (as
//     alpcore.cpp:744); after the replacement the two agree.
//   search (K11/K14, the (e, f) search, encoder.hpp:139-305): no
//     replacement; encode_value<SAFE=true> first tests whether s is
//     "impossible to encode" (not finite, beyond +-ENCODING_UPPER_LIMIT
//     compared as double, or -0.0).
//     f64: such a value never decodes to itself, so it is an exception;
//       otherwise the decoded bits are compared with the value's.  For
//       values that are not impossible this bit comparison and the
//       reference's float one agree: neither side can be NaN or -0.0.
//     f32 (encode_value32_safe, alpcore.cpp:656-667, 692-693): such a
//       value gets n = INT32_MIN and its decode is compared as a float.
//       For every f >= 1, INT32_MIN * 10^f wraps to 0 in 32 bits, so a
//       -0.0 sample decodes to +0.0 == -0.0 and is NOT an exception: it
//       counts with n = INT32_MIN and stretches the segment's range.
//   The float FACT table has 10 entries and f reaches 10: the reference
//   reads past it there, modelled as a NaN decode (alpcore.cpp:644-648),
//   so the pair (10, 10) makes every value an exception; FACT[10] is never
//   read.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "fastlanes.cuh"

namespace alp {

template <typename I>
struct Encoded {
  I n;
  bool exc;
};

// x86 cvttsd2si: truncation toward zero; NaN and values outside
// [-2^63, 2^63) give INT64_MIN.
__device__ __forceinline__ long long cast_x86(double r) {
  return (r >= -9223372036854775808.0 && r < 9223372036854775808.0)
             ? __double2ll_rz(r) : LLONG_MIN;
}

// x86 cvttss2si: truncation toward zero; NaN and values outside
// [-2^31, 2^31) give INT32_MIN.
__device__ __forceinline__ int cast_x86(float r) {
  return (r >= -2147483648.0f && r < 2147483648.0f) ? __float2int_rz(r)
                                                     : INT_MIN;
}

template <typename F> struct Alp;

template <> struct Alp<double> {
  using U = uint64_t;
  using I = long long;
  static constexpr I kMin = LLONG_MIN, kMax = LLONG_MAX;

  // The constant tables (alp_tpu_torch/constants.py DOUBLE, passed as
  // device arrays) and the two scalars of the encode.
  struct Tables {
    const double* exp;        // 10^i
    const double* frac;       // 10^-i
    const long long* fact;    // 10^i as int64
    double magic;             // 2^52 + 2^51
    double upper;             // ENCODING_UPPER_LIMIT (2^63 - 1024)
  };
  // The constants of one (e, f) pair.
  struct Pair {
    double mul_e;             // 10^e
    double mul_f;             // 10^-f
    uint64_t fact;            // FACT[f]
    double frac;              // 10^-e
  };

  static __device__ __forceinline__ Pair pair_of(const Tables& t, int e,
                                                 int f) {
    return {t.exp[e], t.frac[f], static_cast<uint64_t>(t.fact[f]),
            t.frac[e]};
  }
  static __device__ __forceinline__ double scale(double v, const Pair& p) {
    return __dmul_rn(__dmul_rn(v, p.mul_e), p.mul_f);
  }
  static __device__ __forceinline__ I round_cast(double s, double magic) {
    return cast_x86(__dsub_rn(__dadd_rn(s, magic), magic));
  }
  static __device__ __forceinline__ U decoded_bits(I n, const Pair& p) {
    return Num<double>::bits(
        Num<double>::decode(static_cast<uint64_t>(n) * p.fact, p.frac));
  }

  // K9: one value of encode_simdized.
  static __device__ __forceinline__ Encoded<I> encode(U bits, const Pair& p,
                                                      const Tables& t) {
    const bool special = (bits & 0x7FFFFFFFFFFFFFFFull) >= 0x7FF0000000000000ull
                         || bits == 0x8000000000000000ull;  // NaN, Inf, -0.0
    const double vr = special ? t.upper : __longlong_as_double(bits);
    const I n = round_cast(scale(vr, p), t.magic);
    return {n, decoded_bits(n, p) != Num<double>::bits(vr)};
  }

  // K11: one sample of the (e, f) search.
  static __device__ __forceinline__ Encoded<I> search(U bits, const Pair& p,
                                                      const Tables& t) {
    const double s = scale(__longlong_as_double(bits), p);
    const uint64_t sb = Num<double>::bits(s);
    const bool impossible =
        (sb & 0x7FF0000000000000ull) == 0x7FF0000000000000ull
        || s > t.upper || s < -t.upper || sb == 0x8000000000000000ull;
    const I n = round_cast(s, t.magic);
    return {n, impossible || decoded_bits(n, p) != bits};
  }

  // Bit length of the unsigned difference max - min (modulo 2^64).
  static __device__ __forceinline__ int width(I mx, I mn) {
    return 64 - __clzll(static_cast<long long>(static_cast<uint64_t>(mx) -
                                               static_cast<uint64_t>(mn)));
  }
};

template <> struct Alp<float> {
  using U = uint32_t;
  using I = int;
  static constexpr I kMin = INT_MIN, kMax = INT_MAX;

  // constants.py FLOAT's tables as device arrays, the FACT table's length
  // (10: f == 10 decodes NaN), and the scalars of the encode.
  struct Tables {
    const float* exp;         // 10^i
    const float* frac;        // 10^-i
    const int* fact;          // 10^i as int32
    int fact_len;             // entries of fact
    float magic;              // 2^23 + 2^22
    float upper;              // float(ENCODING_UPPER_LIMIT) == 2^63
    double limit;             // ENCODING_UPPER_LIMIT, the search's bound
  };
  struct Pair {
    float mul_e;              // 10^e
    float mul_f;              // 10^-f
    uint32_t fact;            // FACT[f], 0 when f is past the table
    float frac;               // 10^-e
    bool fact_oob;            // f >= fact_len: the decode is NaN
  };

  static __device__ __forceinline__ Pair pair_of(const Tables& t, int e,
                                                 int f) {
    const bool oob = f >= t.fact_len;
    return {t.exp[e], t.frac[f], oob ? 0u : static_cast<uint32_t>(t.fact[f]),
            t.frac[e], oob};
  }
  static __device__ __forceinline__ float scale(float v, const Pair& p) {
    return __fmul_rn(__fmul_rn(v, p.mul_e), p.mul_f);
  }
  static __device__ __forceinline__ I round_cast(float s, float magic) {
    return cast_x86(__fsub_rn(__fadd_rn(s, magic), magic));
  }
  // decode_value32 compared with v as floats; false for a NaN decode.
  static __device__ __forceinline__ bool decodes_to(I n, const Pair& p,
                                                    float v) {
    return !p.fact_oob &&
           Num<float>::decode(static_cast<uint32_t>(n) * p.fact, p.frac) == v;
  }

  // K12: one value of the float encode_simdized (alpcore.cpp:733-745).
  static __device__ __forceinline__ Encoded<I> encode(U bits, const Pair& p,
                                                      const Tables& t) {
    const bool special = (bits & 0x7FFFFFFFu) >= 0x7F800000u
                         || bits == 0x80000000u;            // NaN, Inf, -0.0
    const float vr = special ? t.upper : __uint_as_float(bits);
    const I n = round_cast(scale(vr, p), t.magic);
    return {n, !decodes_to(n, p, vr)};
  }

  // K14: one sample of the float (e, f) search (encode_value32_safe, then
  // the decode compared as a float).
  static __device__ __forceinline__ Encoded<I> search(U bits, const Pair& p,
                                                      const Tables& t) {
    const float v = __uint_as_float(bits);
    const float s = scale(v, p);
    const double sd = static_cast<double>(s);
    const bool impossible = !isfinite(s) || sd > t.limit || sd < -t.limit
                            || __float_as_uint(s) == 0x80000000u;
    const I n = impossible ? INT_MIN : round_cast(s, t.magic);
    return {n, !decodes_to(n, p, v)};
  }

  // Bit length of the unsigned difference max - min (modulo 2^32).
  static __device__ __forceinline__ int width(I mx, I mn) {
    return 32 - __clz(static_cast<int>(static_cast<uint32_t>(mx) -
                                       static_cast<uint32_t>(mn)));
  }
};

}  // namespace alp
