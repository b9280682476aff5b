// Hand-written Hopper (sm_90a) FFOR pack kernel of alp_tpu_torch.
//
//   K10 alp_ffor_pack_f64  replaces _ffor_planes_call
//                          (alp_tpu/kernels/falp.py:2605), reached through
//                          ffor_planes_patch_f64 (:2582; exception slots
//                          take the vector's fill) and ffor_planes_f64
//                          (:2575; no patch).
//
// What it computes.  For each row r of a bucket that shares the bit width
// bw (1..64, at run time): the source vector v = rows[r] of `in` [N, 1024]
// (int64; v = r when rows is null), its exception slots replaced by
// fill[v] when a mask is given, minus base[v] (wrapping, modulo 2^64),
// reduced to the low bw bits and bit-packed in the FastLanes layout the
// ALPT blob stores (16 lanes, value k in lane k % 16 at slot k / 16, word w
// of lane i at w * 16 + i): 16 * bw words written from out[offsets[r]]
// (r * 16 * bw when offsets is null), so every bucket of a column writes
// into one flat buffer in the blob's vector order.  The word formula is
// fastlanes.cuh's pack_word, the inverse of the unpack K1 decodes with:
// both place slot s of a lane with the same slot_pos.
//
// Bound.  Per value it reads 8 bytes of n and 1 byte of mask and writes
// bw / 8 bytes: bytes, ~0.10 ms for a 256 MiB column at 3.35 TB/s.  One
// block of 256 threads per row: the row's 1024 patched, rebased, masked
// values go to shared memory with contiguous loads, then thread j writes
// words j, j + 256, ... of the row, so the stores of a warp are contiguous
// and each word reads the one or few slots that meet it from shared memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "fastlanes.cuh"

namespace {

using alp::kVector;
constexpr int kThreads = 256;
constexpr int kLanes = kVector / 64;

__global__ void __launch_bounds__(kThreads)
ffor_kernel(const uint64_t* __restrict__ in,
            const long long* __restrict__ rows,
            const unsigned char* __restrict__ exc,
            const uint64_t* __restrict__ fill,
            const uint64_t* __restrict__ base, int bw,
            const long long* __restrict__ offsets,
            uint64_t* __restrict__ out) {
  __shared__ uint64_t delta[kVector];
  const long long r = blockIdx.x;
  const long long v = rows ? rows[r] : r;
  const uint64_t b = base[v];
  const uint64_t mask = bw >= 64 ? ~0ull : (1ull << bw) - 1ull;
  const uint64_t fl = exc ? fill[v] : 0ull;
  for (int k = threadIdx.x; k < kVector; k += kThreads) {
    const long long i = v * kVector + k;
    const uint64_t x = (exc && exc[i]) ? fl : in[i];
    delta[k] = (x - b) & mask;
  }
  __syncthreads();
  uint64_t* dst = out + (offsets ? offsets[r] : r * kLanes * bw);
  for (int j = threadIdx.x; j < kLanes * bw; j += kThreads)
    dst[j] = alp::pack_word<uint64_t, 64>(delta, bw, j / kLanes, j % kLanes);
}

}  // namespace

// C interface (loaded with ctypes).  in: int64 [N, 1024]; rows: int64 [m]
// or null; exc: uint8 [N, 1024] and fill: int64 [N], both null or both
// set; base: int64 [N]; bw in 1..64; offsets: int64 [m] or null; out: the
// int64 words.  Returns cudaGetLastError().
extern "C" int alp_ffor_pack_f64(const void* in, const void* rows,
                                 const void* exc, const void* fill,
                                 const void* base, int bw,
                                 const void* offsets, long long m, void* out,
                                 void* stream) {
  if (m < 0 || m > INT_MAX || bw < 1 || bw > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m)
    ffor_kernel<<<static_cast<unsigned>(m), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(in),
        static_cast<const long long*>(rows),
        static_cast<const unsigned char*>(exc),
        static_cast<const uint64_t*>(fill),
        static_cast<const uint64_t*>(base), bw,
        static_cast<const long long*>(offsets),
        static_cast<uint64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
