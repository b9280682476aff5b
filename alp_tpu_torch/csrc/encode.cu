// Hand-written Hopper (sm_90a) ALP encode kernels of alp_tpu_torch.
//
//   K9  alp_encode_f64  replaces alp_encode_f64_tiles_stats
//                       (alp_tpu/kernels/encode.py:402, body
//                       _encode_stats_kernel :332) and, with the stats
//                       off, alp_encode_f64_tiles (:319, body
//                       _encode_kernel :91).
//   K12 alp_encode_f32  replaces alp_encode_f32_tiles_stats (:252, jit
//                       _alp_encode_f32_stats_jit :238, body
//                       _encode_f32_stats_kernel :195) and, with the stats
//                       off, alp_encode_f32_tiles (jit _alp_encode_f32_jit
//                       :165, body _encode_f32_kernel :119).
//
// What they compute.  For each vector v of `values` [n, 1024] (f64 or f32
// bit patterns) and its pair (e[v], f[v]): the encoded integer n and the
// exception flag of every value (encode.cuh's Alp<F>::encode, the host
// engine's encode_simdized), and, with the stats on, per vector the
// exception count, the index of the first non-exception value in value
// order (1024 when there is none) and the min and max of n over the
// non-exceptions (INT_MAX / INT_MIN of n's width when there is none).
// From these the caller derives the bit width, FOR base, enc_max and
// exception fill (device_compress.finalize_encode_stats); the TPU kernels
// reduce per lane and leave the cross-lane part to XLA.  Unlike the TPU
// kernels there is no "rare" output: subnormals (and f64 |s| in [2^52,
// 2^104)) are exact on Hopper (encode.cuh), so no vector needs the host.
//
// Bound.  Per value K9 reads 8 bytes and writes 9 (n and the flag), K12
// reads 4 and writes 5; the arithmetic is about ten float operations and
// an integer product, far below the card's rate for that traffic, so both
// are bound by bytes: a 256 MiB column moves ~570 MB (K9) or ~320 MB (K12),
// ~0.17 / ~0.10 ms at 3.35 TB/s.  The design is the plain one for a
// memory-bound pass, one template for both precisions: one block of 256
// threads per vector, thread t taking values t, t + 256, ... so every load
// and store of a warp is contiguous; the stats reduce in registers, then
// across the warp with shuffles and across the block's 8 warps through
// shared memory.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "encode.cuh"

namespace {

using alp::kVector;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename F>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const typename alp::Alp<F>::U* __restrict__ values,
              const int* __restrict__ exp_idx,
              const int* __restrict__ fac_idx,
              typename alp::Alp<F>::Tables t,
              typename alp::Alp<F>::I* __restrict__ out_n,
              unsigned char* __restrict__ out_exc,
              int* __restrict__ exc_count, int* __restrict__ first,
              typename alp::Alp<F>::I* __restrict__ vmin,
              typename alp::Alp<F>::I* __restrict__ vmax) {
  using A = alp::Alp<F>;
  using I = typename A::I;
  const long long vec = blockIdx.x;
  const typename A::Pair p = A::pair_of(t, exp_idx[vec], fac_idx[vec]);
  I mx = A::kMin, mn = A::kMax;
  int cnt = 0, fk = kVector;
  for (int k = threadIdx.x; k < kVector; k += kThreads) {
    const long long i = vec * kVector + k;
    const alp::Encoded<I> enc = A::encode(values[i], p, t);
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
  __shared__ I s_mx[kWarps], s_mn[kWarps];
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

template <typename F>
int launch(const void* values, const void* e, const void* f,
           const typename alp::Alp<F>::Tables& t, long long n, void* out_n,
           void* out_exc, void* exc_count, void* first, void* vmin,
           void* vmax, void* stream) {
  using A = alp::Alp<F>;
  if (n < 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n)
    encode_kernel<F><<<static_cast<unsigned>(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const typename A::U*>(values),
        static_cast<const int*>(e), static_cast<const int*>(f), t,
        static_cast<typename A::I*>(out_n),
        static_cast<unsigned char*>(out_exc), static_cast<int*>(exc_count),
        static_cast<int*>(first), static_cast<typename A::I*>(vmin),
        static_cast<typename A::I*>(vmax));
  return static_cast<int>(cudaGetLastError());
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
  const alp::Alp<double>::Tables t{static_cast<const double*>(exp_tab),
                                   static_cast<const double*>(frac_tab),
                                   static_cast<const long long*>(fact_tab),
                                   magic, upper};
  return launch<double>(values, e, f, t, n, out_n, out_exc, exc_count, first,
                        vmin, vmax, stream);
}

// The f32 twin: values f32 patterns [n, 1024]; f32 exp / frac tables and
// the int32 fact table of fact_len entries; limit is ENCODING_UPPER_LIMIT
// as a double (unused by the encode, which replaces specials by upper);
// out_n int32 [n, 1024]; vmin, vmax int32 [n].
extern "C" int alp_encode_f32(const void* values, const void* e,
                              const void* f, const void* exp_tab,
                              const void* frac_tab, const void* fact_tab,
                              int fact_len, float magic, float upper,
                              double limit, long long n, void* out_n,
                              void* out_exc, void* exc_count, void* first,
                              void* vmin, void* vmax, void* stream) {
  const alp::Alp<float>::Tables t{static_cast<const float*>(exp_tab),
                                  static_cast<const float*>(frac_tab),
                                  static_cast<const int*>(fact_tab),
                                  fact_len, magic, upper, limit};
  return launch<float>(values, e, f, t, n, out_n, out_exc, exc_count, first,
                       vmin, vmax, stream);
}
