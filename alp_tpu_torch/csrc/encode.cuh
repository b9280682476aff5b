// The ALP f64 encode of one value and its decode-verify, shared by the
// encode kernel K9 (encode.cu) and the (e, f) scorer K11 (score.cu), so the
// search and the encode cannot drift apart.  The decode is fastlanes.cuh's
// Num<double>::decode, the one K1 decodes with.
//
// The reference is the host engine (native/alpcore.cpp, encoder.hpp:82-106,
// 307-400), whose blobs the port's must equal byte for byte:
//
//   scale   s = RN(RN(v * 10^e) * 10^-f)                 (two products)
//   round   r = RN(RN(s + MAGIC) - MAGIC)                (MAGIC = 2^52+2^51)
//   cast    n = trunc(r) if -2^63 <= r < 2^63, else INT64_MIN
//                                        (x86 cvttsd2si; NaN -> INT64_MIN)
//   decode  d = RN(RN(double(int64(uint64(n) * FACT[f]))) * 10^-e)
//
// Every operation is an _rn intrinsic, which nvcc never contracts into an
// FMA (its default would fuse the magic round's add into the product);
// the cast tests the range first, because __double2ll_rz saturates and
// maps NaN to 0 where x86 writes INT64_MIN.  The build passes no fast-math
// or flush-to-zero flag: Hopper's FP64 keeps subnormals, so subnormal
// inputs and |s| in [2^52, 2^104) are computed exactly here, where the TPU
// kernels flag them "rare" for a host re-encode.
//
// Two equalities, as in the reference:
//   encode_value (K9, encode_simdized): NaN, +-Inf and -0.0 are replaced by
//     ENCODING_UPPER_LIMIT first; a value is an exception when the decoded
//     bits differ from the replaced value's.
//   search_value (K11, the (e, f) search, encoder.hpp:139-305): no
//     replacement; encode_value<SAFE=true> first tests whether s is
//     "impossible to encode" (not finite, beyond +-ENCODING_UPPER_LIMIT, or
//     -0.0).  Such a value never decodes to itself, so it is an exception
//     (its n is then never read); otherwise the value is an exception when
//     the decoded bits differ from its own.  For values that are not
//     impossible the float comparison of the reference and this bit
//     comparison agree: neither side can be NaN or -0.0.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "fastlanes.cuh"

namespace alp {

// The constant tables (alp_tpu_torch/constants.py, passed as device
// arrays) and the two scalars of the encode.
struct EncodeTables {
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

__device__ __forceinline__ Pair pair_of(const EncodeTables& t, int e, int f) {
  return {t.exp[e], t.frac[f], static_cast<uint64_t>(t.fact[f]), t.frac[e]};
}

__device__ __forceinline__ uint64_t bits_of(double v) {
  return static_cast<uint64_t>(__double_as_longlong(v));
}

// x86 cvttsd2si: truncation toward zero; NaN and values outside
// [-2^63, 2^63) give INT64_MIN.
__device__ __forceinline__ long long cast_x86(double r) {
  return (r >= -9223372036854775808.0 && r < 9223372036854775808.0)
             ? __double2ll_rz(r) : LLONG_MIN;
}

__device__ __forceinline__ double scale(double v, const Pair& p) {
  return __dmul_rn(__dmul_rn(v, p.mul_e), p.mul_f);
}

__device__ __forceinline__ long long round_cast(double s, double magic) {
  return cast_x86(__dsub_rn(__dadd_rn(s, magic), magic));
}

__device__ __forceinline__ uint64_t decoded_bits(long long n, const Pair& p) {
  return Num<double>::bits(
      Num<double>::decode(static_cast<uint64_t>(n) * p.fact, p.frac));
}

struct Encoded {
  long long n;
  bool exc;
};

// K9: one value of encode_simdized.
__device__ __forceinline__ Encoded encode_value(uint64_t bits, const Pair& p,
                                                const EncodeTables& t) {
  const bool special = (bits & 0x7FFFFFFFFFFFFFFFull) >= 0x7FF0000000000000ull
                       || bits == 0x8000000000000000ull;   // NaN, Inf, -0.0
  const double vr = special ? t.upper : __longlong_as_double(bits);
  const long long n = round_cast(scale(vr, p), t.magic);
  return {n, decoded_bits(n, p) != bits_of(vr)};
}

// K11: one sample of the (e, f) search.
__device__ __forceinline__ Encoded search_value(uint64_t bits, const Pair& p,
                                                const EncodeTables& t) {
  const double s = scale(__longlong_as_double(bits), p);
  const uint64_t sb = bits_of(s);
  const bool impossible = (sb & 0x7FF0000000000000ull) == 0x7FF0000000000000ull
                          || s > t.upper || s < -t.upper
                          || sb == 0x8000000000000000ull;
  const long long n = round_cast(s, t.magic);
  return {n, impossible || decoded_bits(n, p) != bits};
}

}  // namespace alp
