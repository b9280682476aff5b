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
//                    over 32-bit words, by another design than K3's.
//
// Two more serve the port's bench (alp_tpu_torch/bench_speed.py and the
// sum step of engine.make_sum_step):
//
//   K20 alp_variant_sum_f64  replaces falp_decode_f64_variant_sum
//                    (falp.py:933): K1's decode of one f64 ALP bucket at
//                    any bit width, each value cut to float by the
//                    reference's truncating convert _f64_bits_to_f32
//                    (falp.py:456-464: exponent clamped to [0, 254], the
//                    mantissa's low 29 bits dropped, not rounded), summed
//                    in float per FastLanes lane: out[v, l] = sum over
//                    slots s = 0..63, in that order, of value 16 s + l of
//                    vector v.  A checksum for throughput steps, not a SUM:
//                    exceptions are not written in and the pad of a partial
//                    vector is summed as decoded, as the TPU kernel does.
//   K21 alp_rd_glue_f64 / _f32  replace rd_decode_f64 (falp.py:1388) and
//                    rd_decode_f32 (:2392): ALP_RD without the dictionary.
//                    The right parts are unFFORed at rbw (base 0) and the
//                    left parts, already resolved and patched (uint32
//                    [n, 1024], one a value), are glued above them:
//                    bits = (left << rbw) | right, or right alone at
//                    rbw == S (a shift by the word width gives 0 in XLA).
//                    f64 takes rbw 48..64 (the reference cuts at most 16
//                    left bits); f32 0..32, rbw 0 giving the left word.
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
// the card's FP64 rate.  K1/K2 take the simple design for a memory-bound
// pass: one block per vector, the vector's packed words staged once into
// shared memory with coalesced loads, then each thread extracts values
// k, k + 256, ... so that the stores of a warp are contiguous.
//
// K3/K4 decode twice K1's fields a value (the right part and the index),
// and K4 writes half K3's bytes a value: the first design (K1's, with
// unpack() of both parts, a runtime slot * bw with its divide and modulo
// and one or two shared loads each) was set by its instructions a value,
// not its bytes (K4 at 45 % of its byte bound, K3 at 66 %).  The present
// K4 reads both parts as lane streams (one thread a right lane, below; no
// staging, no barrier), as K20 and K7/K8 do; K3 keeps the first design's
// block a vector but reads its words straight from device memory.
// kernel_ablations.py times them against the first design (k4_staged) and
// its splits (k4_no_index, k4_no_unpack, k4_no_stage: the present K3), the
// dictionary in registers (k4_register_dict), K3 on the lane streams
// (k4_stream_f64) and the step and block sweeps.
//
// K20 reads bw / 8 bytes a value and writes 4 / 64, and does the unpack,
// the FOR add, the 64-bit FACT product, two FP64 operations, ~8 integer
// operations of the cut and one float add: bound by operations at small
// bit widths, by the packed bytes from bw ~30 up (chip_smoke.py's
// VSUM_OPS).  Sixteen threads take a vector, one a lane (the words of the
// 16 lanes are adjacent, so a half warp reads 128 contiguous bytes); a
// thread keeps its sum in a register in slot order and writes one float:
// no shared memory, no reduction across threads.  The first design called
// unpack() for every slot: a runtime slot * bw with its divide and modulo,
// one or two loads of the lane's words (each word loaded again for every
// slot it holds, up to 128 loads a lane) and three 64-bit shifts and a
// computed mask.  The present design reads the lane as a stream
// (fastlanes.cuh's LaneStream): bw loads a lane, each two words ahead of
// its first use, a funnel shift and one mask a field; it takes 4 fields a
// step and decodes and cuts them as independent chains before adding them
// in slot order, so the decode of later slots overlaps the in-order float
// adds; at bw = 0 it decodes once.  kernel_ablations.py times it against
// the per-slot unpack (k20_slot_unpack), a word-by-word loop of one field
// at a time (k20_word_loop: fewer instructions, slower), loading each
// field's words where it is taken (k20_direct), the 2^52 magic add for
// the int64 -> double convert (k20_magic_convert) and no convert
// (k20_no_convert).  K21 moves bytes, as K1 does: one block a
// vector, the right words staged in shared memory, each thread writing
// values k, k + 256, ... so a warp's loads of the left parts and stores of
// the bits are contiguous.
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

// K3 / K4: ALP_RD glue.  Indexes past the dictionary (exceptions) are
// clamped to its last entry, as the host decode does; the exception
// scatter overwrites them afterwards.  Two designs, one a width, each the
// faster on its own (kernel_ablations.py, PERF.md):
//
// K4: one thread a FastLanes lane of the right part (L = 1024 / S = 32
// lanes), so a warp decodes one vector, with no barrier.  The thread reads
// its lane's right fields as a stream (LaneStream); value k = i + L s of
// lane i has its index in left lane k % 64 at slot k / 64, so it also
// reads the Q = 64 / L left lanes i + L q it meets, each as a stream of 16
// fields, taking them in turn.  A vector's 8 u16 entries are copied to
// shared memory by its first lanes and read there.  A step takes kRdStep
// values of the lane, so the steps' extract chains overlap, and a warp's
// store of one value a lane is 128 contiguous bytes.
//
// K3: one block a vector, each thread values k, k + 256, ... by unpack() of
// both parts straight from device memory (the lanes of a warp read
// neighbouring words, which L1 keeps for the slots that share them), so a
// warp's stores are contiguous.  K3 writes 8 bytes a value and reads
// ~7 (the right part at 48-64 bits): its bytes, not its instructions, set
// its pace, and one vector a block keeps more loads in flight than a lane
// stream, which holds two words ahead of its fields.
constexpr int kRdThreads = 256;
constexpr int kRdStep = 4;                   // a lane's values a step

template <typename U, int S>
__global__ void __launch_bounds__(kRdThreads)
rd_stream_kernel(const U* __restrict__ right, int rbw,
                 const uint16_t* __restrict__ left, int lbw,
                 const uint16_t* __restrict__ dict,
                 const int* __restrict__ dict_size,
                 const long long* __restrict__ rows, U* __restrict__ out,
                 long long n) {
  constexpr int L = kVector / S, Q = 64 / L;
  constexpr unsigned kLanes = L == 32 ? 0xffffffffu : (1u << (L % 32)) - 1;
  static_assert(kRdStep % Q == 0, "a step takes each left lane in turn");
  __shared__ uint16_t entries[kRdThreads / L][8];
  uint16_t* mine = entries[threadIdx.x / L];
  const long long vec =
      (static_cast<long long>(blockIdx.x) * kRdThreads + threadIdx.x) / L;
  const int lane = threadIdx.x % L;
  if (vec >= n) return;
  if (lane < 8) mine[lane] = dict[vec * 8 + lane];
  __syncwarp(kLanes << ((threadIdx.x & 31) / L * L));   // the vector's lanes
  const uint32_t last = max(min(dict_size[vec], 8) - 1, 0);
  alp::LaneStream<U> rs(right + vec * rbw * L + lane, rbw);
  alp::LaneStream<uint16_t> ls[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q)
    ls[q] = alp::LaneStream<uint16_t>(left + vec * lbw * 64 + lane + L * q,
                                      lbw);
  U* dst = out + (rows ? rows[vec] : vec) * kVector + lane;
  for (int s = 0; s < S; s += kRdStep) {
    U v[kRdStep];
#pragma unroll
    for (int q = 0; q < kRdStep; ++q) {
      const U r = rs.next();
      const U l = mine[min(static_cast<uint32_t>(ls[q % Q].next()), last)];
      v[q] = rbw < S ? static_cast<U>(static_cast<U>(l << rbw) | r) : r;
    }
#pragma unroll
    for (int q = 0; q < kRdStep; ++q) dst[(s + q) * L] = v[q];
  }
}

template <typename U, int S>
__global__ void __launch_bounds__(kThreads)
rd_block_kernel(const U* __restrict__ right, int rbw,
                const uint16_t* __restrict__ left, int lbw,
                const uint16_t* __restrict__ dict,
                const int* __restrict__ dict_size,
                const long long* __restrict__ rows, U* __restrict__ out) {
  const long long vec = blockIdx.x;
  const U* rwords = right + vec * rbw * (kVector / S);
  const uint16_t* lwords = left + vec * lbw * (kVector / 16);
  const uint16_t* entries = dict + vec * 8;
  const int last = max(min(dict_size[vec], 8) - 1, 0);
  U* dst = out + (rows ? rows[vec] : vec) * kVector;
  for (int k = threadIdx.x; k < kVector; k += kThreads) {
    const U r = rbw ? unpack<U, S>(rwords, rbw, k) : U(0);
    const int idx = lbw ? unpack<uint16_t, 16>(lwords, lbw, k) : 0;
    const U l = entries[min(idx, last)];
    dst[k] = rbw < S ? static_cast<U>(static_cast<U>(l << rbw) | r) : r;
  }
}

// The reference's truncating f64-bits -> float convert (falp.py:456-464),
// operation for operation: not IEEE rounding, and +-Inf / NaN come out as
// large finite floats.
__device__ __forceinline__ float trunc_f32(uint64_t b) {
  const uint32_t hi = static_cast<uint32_t>(b >> 32);
  const uint32_t lo = static_cast<uint32_t>(b);
  const uint32_t sign = hi & 0x80000000u;
  const int e = static_cast<int>((hi >> 20) & 0x7FFu);
  const uint32_t e32 = static_cast<uint32_t>(min(max(e - 896, 0), 254));
  const uint32_t m = ((hi & 0xFFFFFu) << 3) | (lo >> 29);
  return __uint_as_float(sign | (e32 << 23) | m);
}

constexpr int kLanes64 = kVector / 64;       // FastLanes lanes of f64: 16
constexpr int kSlots64 = kVector / kLanes64;  // values a lane: 64

constexpr int kSumStep = 4;                  // K20's slots a step

// K20: one thread a (vector, lane); 16 vectors a block.  A step takes
// kSumStep fields off the lane's stream, decodes and cuts them
// (independent chains), then adds them in slot order.  At bit width 0
// every field is 0: one decode, added 64 times in order.
__global__ void __launch_bounds__(kThreads)
variant_sum_kernel(const uint64_t* __restrict__ packed, int bw,
                   const uint64_t* __restrict__ base,
                   const uint64_t* __restrict__ fact,
                   const double* __restrict__ frac, long long n,
                   float* __restrict__ out) {
  const long long vec = static_cast<long long>(blockIdx.x) *
                            (kThreads / kLanes64) + threadIdx.x / kLanes64;
  const int lane = threadIdx.x % kLanes64;
  if (vec >= n) return;
  const uint64_t b = base[vec], f = fact[vec];
  const double fr = frac[vec];
  const auto cut = [&](uint64_t u) {
    return trunc_f32(Num<double>::bits(
        Num<double>::decode(static_cast<uint64_t>((b + u) * f), fr)));
  };
  float acc = 0.0f;
  if (bw == 0) {
    const float t = cut(0);
    for (int s = 0; s < kSlots64; ++s) acc = __fadd_rn(acc, t);
  } else {
    alp::LaneStream<uint64_t> in(packed + vec * bw * kLanes64 + lane, bw);
    for (int s = 0; s < kSlots64; s += kSumStep) {
      float t[kSumStep];
#pragma unroll
      for (int q = 0; q < kSumStep; ++q) t[q] = cut(in.next());
#pragma unroll
      for (int q = 0; q < kSumStep; ++q) acc = __fadd_rn(acc, t[q]);
    }
  }
  out[vec * kLanes64 + lane] = acc;
}

// K21: one block a vector.
template <typename U, int S>
__global__ void __launch_bounds__(kThreads)
rd_glue_kernel(const U* __restrict__ right, int rbw,
               const uint32_t* __restrict__ left, U* __restrict__ out) {
  __shared__ U rwords[kVector];
  const long long vec = blockIdx.x;
  stage<U, S>(rwords, right + vec * rbw * (kVector / S), rbw);
  __syncthreads();
  const uint32_t* lsrc = left + vec * kVector;
  U* dst = out + vec * kVector;
  for (int k = threadIdx.x; k < kVector; k += kThreads) {
    const U r = rbw ? unpack<U, S>(rwords, rbw, k) : U(0);
    dst[k] = rbw < S ? static_cast<U>(static_cast<U>(
                           static_cast<U>(lsrc[k]) << rbw) | r)
                     : r;
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
  const auto r = static_cast<const U*>(right);
  const auto l = static_cast<const uint16_t*>(left);
  const auto d = static_cast<const uint16_t*>(dict);
  const auto ds = static_cast<const int*>(dict_size);
  const auto rw = static_cast<const long long*>(rows);
  const auto o = static_cast<U*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if constexpr (S == 64) {
    rd_block_kernel<U, S><<<static_cast<unsigned>(n), kThreads, 0, st>>>(
        r, rbw, l, lbw, d, ds, rw, o);
  } else {
    constexpr long long kPerBlock = kRdThreads / (kVector / S);  // vectors
    rd_stream_kernel<U, S>
        <<<static_cast<unsigned>((n + kPerBlock - 1) / kPerBlock),
           kRdThreads, 0, st>>>(r, rbw, l, lbw, d, ds, rw, o, n);
  }
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

// K20.  packed: uint64 [n, bw * 16]; base, fact: [n]; frac: double [n];
// out: float [n, 16].
extern "C" int alp_variant_sum_f64(const void* packed, int bw,
                                   const void* base, const void* fact,
                                   const void* frac, long long n, void* out,
                                   void* stream) {
  constexpr long long kPerBlock = kThreads / kLanes64;
  if (n < 0 || n > INT_MAX || bw < 0 || bw > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    variant_sum_kernel<<<static_cast<unsigned>((n + kPerBlock - 1) /
                                               kPerBlock),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(packed), bw,
        static_cast<const uint64_t*>(base),
        static_cast<const uint64_t*>(fact), static_cast<const double*>(frac),
        n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename U, int S>
static int launch_rd_glue(const void* right, int rbw, const void* left,
                          long long n, void* out, void* stream,
                          int min_rbw) {
  if (n < 0 || n > INT_MAX || rbw < min_rbw || rbw > S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0)
    rd_glue_kernel<U, S><<<static_cast<unsigned>(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const U*>(right), rbw,
        static_cast<const uint32_t*>(left), static_cast<U*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K21.  right: [n, rbw * 1024 / S] words; left: uint32 [n, 1024]; out:
// [n, 1024] bit patterns.
extern "C" int alp_rd_glue_f64(const void* right, int rbw, const void* left,
                               long long n, void* out, void* stream) {
  return launch_rd_glue<uint64_t, 64>(right, rbw, left, n, out, stream, 48);
}

extern "C" int alp_rd_glue_f32(const void* right, int rbw, const void* left,
                               long long n, void* out, void* stream) {
  return launch_rd_glue<uint32_t, 32>(right, rbw, left, n, out, stream, 0);
}
