// Hand-written Hopper (sm_90a) ALP f64 encode kernel of alp_tpu_torch.
//
//   K9 alp_encode_f64  replaces alp_encode_f64_tiles_stats
//                      (alp_tpu/kernels/encode.py:402, body
//                      _encode_stats_kernel :332) and, with the stats
//                      off, alp_encode_f64_tiles (:319, body
//                      _encode_kernel :91).
//
// What it computes.  For each vector v of `values` [n, 1024] (f64 bit
// patterns) and its pair (e[v], f[v]): the encoded integer n and the
// exception flag of every value (encode.cuh's encode_value, the host
// engine's encode_simdized), and, with the stats on, per vector the
// exception count, the index of the first non-exception value in value
// order (1024 when there is none) and the int64 min and max of n over the
// non-exceptions (INT64_MAX / INT64_MIN when there is none).  From these
// the caller derives the bit width, FOR base, enc_max and exception fill
// (device_compress.finalize_encode_stats); the TPU kernel reduces per lane
// and leaves the cross-lane part to XLA.  Unlike the TPU kernel there is
// no "rare" output: subnormals and |s| in [2^52, 2^104) are exact on
// Hopper's FP64 (encode.cuh), so no vector needs a host re-encode.
//
// Bound.  Per value it reads 8 bytes and writes 9 (n and the flag); the
// arithmetic is about ten FP64 operations and a 64-bit product, far below
// the card's rate for that traffic, so the kernel is bound by bytes: a
// 256 MiB column moves ~570 MB, ~0.17 ms at 3.35 TB/s.  The design is the
// plain one for a memory-bound pass: one block of 256 threads per vector,
// thread t taking values t, t + 256, ... so every load and store of a warp
// is contiguous; the stats reduce in registers, then across the warp with
// shuffles and across the block's 8 warps through shared memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "encode.cuh"

namespace {

using alp::kVector;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
encode_kernel(const uint64_t* __restrict__ values,
              const int* __restrict__ exp_idx,
              const int* __restrict__ fac_idx, alp::EncodeTables t,
              long long* __restrict__ out_n,
              unsigned char* __restrict__ out_exc,
              int* __restrict__ exc_count, int* __restrict__ first,
              long long* __restrict__ vmin, long long* __restrict__ vmax) {
  const long long vec = blockIdx.x;
  const alp::Pair p = alp::pair_of(t, exp_idx[vec], fac_idx[vec]);
  long long mx = LLONG_MIN, mn = LLONG_MAX;
  int cnt = 0, fk = kVector;
  for (int k = threadIdx.x; k < kVector; k += kThreads) {
    const long long i = vec * kVector + k;
    const alp::Encoded enc = alp::encode_value(values[i], p, t);
    out_n[i] = enc.n;
    out_exc[i] = enc.exc;
    if (enc.exc) {
      ++cnt;
    } else {
      mx = max(mx, enc.n);
      mn = min(mn, enc.n);
      fk = min(fk, k);
    }
  }
  if (!exc_count) return;                    // stats off: uniform exit
  for (int o = 16; o > 0; o >>= 1) {
    mx = max(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
    mn = min(mn, __shfl_xor_sync(0xFFFFFFFFu, mn, o));
    cnt += __shfl_xor_sync(0xFFFFFFFFu, cnt, o);
    fk = min(fk, __shfl_xor_sync(0xFFFFFFFFu, fk, o));
  }
  __shared__ long long s_mx[kWarps], s_mn[kWarps];
  __shared__ int s_cnt[kWarps], s_fk[kWarps];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s_mx[warp] = mx;
    s_mn[warp] = mn;
    s_cnt[warp] = cnt;
    s_fk[warp] = fk;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      mx = max(mx, s_mx[w]);
      mn = min(mn, s_mn[w]);
      cnt += s_cnt[w];
      fk = min(fk, s_fk[w]);
    }
    exc_count[vec] = cnt;
    first[vec] = fk;
    vmin[vec] = mn;
    vmax[vec] = mx;
  }
}

}  // namespace

// C interface (loaded with ctypes).  values: f64 patterns [n, 1024]; e, f:
// int32 [n]; exp_tab, frac_tab: f64 tables, fact_tab: int64 table; out_n
// int64 [n, 1024], out_exc uint8 [n, 1024]; the four stats outputs [n]
// (int32, int32, int64, int64) are all null (stats off) or all set.
// Returns cudaGetLastError().
extern "C" int alp_encode_f64(const void* values, const void* e,
                              const void* f, const void* exp_tab,
                              const void* frac_tab, const void* fact_tab,
                              double magic, double upper, long long n,
                              void* out_n, void* out_exc, void* exc_count,
                              void* first, void* vmin, void* vmax,
                              void* stream) {
  if (n < 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const alp::EncodeTables t{static_cast<const double*>(exp_tab),
                            static_cast<const double*>(frac_tab),
                            static_cast<const long long*>(fact_tab), magic,
                            upper};
  if (n)
    encode_kernel<<<static_cast<unsigned>(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(values), static_cast<const int*>(e),
        static_cast<const int*>(f), t, static_cast<long long*>(out_n),
        static_cast<unsigned char*>(out_exc), static_cast<int*>(exc_count),
        static_cast<int*>(first), static_cast<long long*>(vmin),
        static_cast<long long*>(vmax));
  return static_cast<int>(cudaGetLastError());
}
