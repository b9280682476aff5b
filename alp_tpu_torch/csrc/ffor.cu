// Hand-written Hopper (sm_90a) FFOR pack kernels of alp_tpu_torch.
//
//   K10 alp_ffor_pack_f64  replaces _ffor_planes_call
//                          (alp_tpu/kernels/falp.py:2605), reached through
//                          ffor_planes_patch_f64 (:2582; exception slots
//                          take the vector's fill) and ffor_planes_f64
//                          (:2575; no patch).
//   K13 alp_ffor_pack_f32  replaces ffor_tile (:2635, body _ffor_kernel
//                          :2482) at element_bits=32, which the f32 device
//                          compress calls for the ALP vectors and the
//                          ALP_RD right parts (at 64 bits ffor_tile is
//                          K10's function).
//
//   K22 alp_unffor_f64 / _f32  replace unffor_tile (:2455, body
//                          _unffor_kernel :2413) at element_bits 64 and
//                          32: unFFOR alone, the inverse of K10 / K13.
//                          Vector v's bw * L packed words plus base[v]
//                          (wrapping) give its 1024 integers, in value
//                          order; at bw 0 every value is the base.  At 32
//                          bits the output is the low word of unpacked +
//                          base, which is all the TPU kernel writes.  Every
//                          decode kernel fuses this unpack; the standalone
//                          kernel serves the bench's unFFOR rows.
//
// What they compute.  For each row r of a bucket that shares the bit
// width bw (1..S, at run time; S = 64 for K10, 32 for K13): the source
// vector v = rows[r] of `in` [N, 1024] (int64 / int32; v = r when rows is
// null), its exception slots replaced by fill[v] when a mask is given,
// minus base[v] (wrapping, modulo 2^S), reduced to the low bw bits and
// bit-packed in the FastLanes layout the ALPT blob stores (L = 1024 / S
// lanes, value k in lane k % L at slot k / L, word w of lane i at
// w * L + i): L * bw words written from out[offsets[r]] (r * L * bw when
// offsets is null), so every bucket of a column writes into one flat
// buffer in the blob's vector order.  The word formula is fastlanes.cuh's
// pack_word, the inverse of the unpack K1/K2 decode with: both place slot
// s of a lane with the same slot_pos.  One template serves both widths.
//
// Bound.  Per value K10 reads 8 bytes of n and 1 byte of mask and writes
// bw / 8 bytes, K13 4 + 1 and bw / 8: bytes, ~0.10 / ~0.07 ms for a
// 256 MiB column at 3.35 TB/s.  One block of 256 threads per row: the
// row's 1024 patched, rebased, masked values go to shared memory with
// contiguous loads, then thread j writes words j, j + 256, ... of the row,
// so the stores of a warp are contiguous and each word reads the one or
// few slots that meet it from shared memory.  K22 is bound by bytes too
// (bw / 8 read, 8 or 4 written a value) and is K1's design without the
// float: one block a vector, its words staged in shared memory, thread j
// writing values j, j + 256, ... with fastlanes.cuh's unpack.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "fastlanes.cuh"

namespace {

using alp::kVector;
constexpr int kThreads = 256;

template <typename W, int S>
__global__ void __launch_bounds__(kThreads)
ffor_kernel(const W* __restrict__ in, const long long* __restrict__ rows,
            const unsigned char* __restrict__ exc,
            const W* __restrict__ fill, const W* __restrict__ base, int bw,
            const long long* __restrict__ offsets, W* __restrict__ out) {
  constexpr int kLanes = kVector / S;
  __shared__ W delta[kVector];
  const long long r = blockIdx.x;
  const long long v = rows ? rows[r] : r;
  const W b = base[v];
  const W mask = bw >= S ? static_cast<W>(~W(0))
                         : static_cast<W>((W(1) << bw) - W(1));
  const W fl = exc ? fill[v] : W(0);
  for (int k = threadIdx.x; k < kVector; k += kThreads) {
    const long long i = v * kVector + k;
    const W x = (exc && exc[i]) ? fl : in[i];
    delta[k] = static_cast<W>(x - b) & mask;
  }
  __syncthreads();
  W* dst = out + (offsets ? offsets[r] : r * kLanes * bw);
  for (int j = threadIdx.x; j < kLanes * bw; j += kThreads)
    dst[j] = alp::pack_word<W, S>(delta, bw, j / kLanes, j % kLanes);
}

template <typename W, int S>
__global__ void __launch_bounds__(kThreads)
unffor_kernel(const W* __restrict__ packed, int bw,
              const W* __restrict__ base, W* __restrict__ out) {
  __shared__ W words[kVector];
  const long long v = blockIdx.x;
  alp::stage<W, S>(words, packed + v * bw * (kVector / S), bw);
  __syncthreads();
  const W b = base[v];
  W* dst = out + v * kVector;
  for (int k = threadIdx.x; k < kVector; k += kThreads)
    dst[k] = static_cast<W>(b + (bw ? alp::unpack<W, S>(words, bw, k)
                                    : W(0)));
}

template <typename W, int S>
int launch_unffor(const void* packed, int bw, const void* base, long long n,
                  void* out, void* stream) {
  if (n < 0 || n > INT_MAX || bw < 0 || bw > S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n)
    unffor_kernel<W, S><<<static_cast<unsigned>(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const W*>(packed), bw, static_cast<const W*>(base),
        static_cast<W*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename W, int S>
int launch(const void* in, const void* rows, const void* exc,
           const void* fill, const void* base, int bw, const void* offsets,
           long long m, void* out, void* stream) {
  if (m < 0 || m > INT_MAX || bw < 1 || bw > S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m)
    ffor_kernel<W, S><<<static_cast<unsigned>(m), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const W*>(in), static_cast<const long long*>(rows),
        static_cast<const unsigned char*>(exc), static_cast<const W*>(fill),
        static_cast<const W*>(base), bw,
        static_cast<const long long*>(offsets), static_cast<W*>(out));
  return static_cast<int>(cudaGetLastError());
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
  return launch<uint64_t, 64>(in, rows, exc, fill, base, bw, offsets, m, out,
                              stream);
}

// The 32-bit twin: in, fill, base and out int32, bw in 1..32; rows and
// offsets int64.
extern "C" int alp_ffor_pack_f32(const void* in, const void* rows,
                                 const void* exc, const void* fill,
                                 const void* base, int bw,
                                 const void* offsets, long long m, void* out,
                                 void* stream) {
  return launch<uint32_t, 32>(in, rows, exc, fill, base, bw, offsets, m, out,
                              stream);
}

// K22.  packed: [n, bw * 1024 / S] words (int64 for 64-bit elements,
// int32 for 32); base: [n] of the same type; bw in 0..S; out: [n, 1024].
extern "C" int alp_unffor_f64(const void* packed, int bw, const void* base,
                              long long n, void* out, void* stream) {
  return launch_unffor<uint64_t, 64>(packed, bw, base, n, out, stream);
}

extern "C" int alp_unffor_f32(const void* packed, int bw, const void* base,
                              long long n, void* out, void* stream) {
  return launch_unffor<uint32_t, 32>(packed, bw, base, n, out, stream);
}
