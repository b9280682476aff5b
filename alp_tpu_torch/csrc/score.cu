// Hand-written Hopper (sm_90a) (e, f) scoring kernels of alp_tpu_torch.
//
//   K11 alp_score_pairs_f64  replaces score_pairs_f64
//                            (alp_tpu/kernels/score.py:533, body
//                            _score_kernel :53), which both planning
//                            levels call (_first_level_scores_f64_lanes
//                            :265, second_level_scores_f64 :282), and the
//                            rows layout of the first level,
//                            first_level_scores_f64 (:223, body
//                            _score_rows_kernel :137, reductions in XLA
//                            :237-262).
//   K14 alp_score_pairs_f32  replaces score_pairs_f32 (:498, body
//                            _score_f32_kernel :337), which
//                            first_level_scores_f32 (:418) and
//                            second_level_scores_f32 (:439) call.
//
// What they compute.  For each segment s of 32 samples (f64 or f32 bit
// patterns, `samples` [n, 32]) and each of its C candidate pairs (e, f)
// (`ef` int32 [n, C, 2], or [1, C, 2] shared by every segment): the number
// of samples that are not exceptions under the reference's (e, f) search
// (encode.cuh's Alp<F>::search: encode_value<SAFE=true>, then the decode
// compared), and the reference's size estimate
//   est = 32 * bits((max - min) mod 2^W) + (32 - non_exc) * exc_bits
// with max / min the W-bit extremes of n over the non-exceptions
// (exc_bits 80 for f64, 48 for f32).  A segment with no non-exception
// keeps the INT_MIN / INT_MAX starting values, whose difference wraps to 1
// (encoder.hpp:268-269), as in the reference.  Candidates c >=
// k_count[s] (when k_count is given) are not scored and read 0.  The first
// planning level scores the 190 (f64) or 66 (f32) pairs of
// find_top_k_combinations on each sampled vector of a rowgroup, the second
// the <= 5 pairs of each vector's rowgroup on its 32-value stride; the vote
// and the accept scan run in PyTorch (ops/alp.py).  K14 follows the host
// search, not the TPU scorer: it replaces no special value, so a -0.0
// sample at f >= 1 counts as a non-exception with n = INT32_MIN
// (encode.cuh).
//
// Bound.  Operations: one encode + verify (~10 float operations and an
// integer product) per (sample, candidate), then a min, a max and a count;
// the samples are a few MB.  A 256 MiB f64 column asks for ~17.9 M
// first-level and ~5.2 M second-level trials, a 256 MiB f32 column ~12.4 M
// and up to ~10.5 M.  One warp per (segment, candidate), one sample per
// lane: min, max and the count are warp shuffles (32-bit ones for f32) and
// a ballot, with no shared memory and no divergence; the warps of a
// segment read its 32 samples through the caches.  The same grid shape
// serves both levels and both precisions.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "encode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSamples = 32;

template <typename F>
__global__ void __launch_bounds__(kThreads)
score_kernel(const typename alp::Alp<F>::U* __restrict__ samples,
             const int* __restrict__ ef, int ef_per_segment, int n_cand,
             const int* __restrict__ k_count, long long n_tasks,
             typename alp::Alp<F>::Tables t, int exc_bits,
             int* __restrict__ est, int* __restrict__ non_exc) {
  using A = alp::Alp<F>;
  using I = typename A::I;
  const long long task =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (task >= n_tasks) return;               // whole warps leave together
  const long long seg = task / n_cand;
  const int c = static_cast<int>(task % n_cand);
  if (k_count && c >= k_count[seg]) {
    if (lane == 0) est[task] = non_exc[task] = 0;
    return;
  }
  const int* pair = ef + 2 * ((ef_per_segment ? seg * n_cand : 0) + c);
  const typename A::Pair p = A::pair_of(t, pair[0], pair[1]);
  const alp::Encoded<I> enc =
      A::search(samples[seg * kSamples + lane], p, t);
  I mx = enc.exc ? A::kMin : enc.n;
  I mn = enc.exc ? A::kMax : enc.n;
  for (int o = 16; o > 0; o >>= 1) {
    mx = max(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
    mn = min(mn, __shfl_xor_sync(0xFFFFFFFFu, mn, o));
  }
  const int ne = __popc(__ballot_sync(0xFFFFFFFFu, !enc.exc));
  if (lane == 0) {
    est[task] = kSamples * A::width(mx, mn) + (kSamples - ne) * exc_bits;
    non_exc[task] = ne;
  }
}

template <typename F>
int launch(const void* samples, const void* ef, int ef_per_segment,
           int n_cand, const void* k_count, long long n,
           const typename alp::Alp<F>::Tables& t, int exc_bits, void* est,
           void* non_exc, void* stream) {
  const long long tasks = n * n_cand;
  const long long blocks = (tasks * 32 + kThreads - 1) / kThreads;
  if (n < 0 || n_cand < 1 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tasks)
    score_kernel<F><<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const typename alp::Alp<F>::U*>(samples),
        static_cast<const int*>(ef), ef_per_segment, n_cand,
        static_cast<const int*>(k_count), tasks, t, exc_bits,
        static_cast<int*>(est), static_cast<int*>(non_exc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes).  samples: f64 patterns [n, 32]; ef:
// int32 [n or 1, n_cand, 2] (ef_per_segment 1 or 0); k_count: int32 [n]
// or null; the f64 / int64 tables; est, non_exc: int32 [n, n_cand].
// Returns cudaGetLastError().
extern "C" int alp_score_pairs_f64(const void* samples, const void* ef,
                                   int ef_per_segment, int n_cand,
                                   const void* k_count, long long n,
                                   const void* exp_tab, const void* frac_tab,
                                   const void* fact_tab, double magic,
                                   double upper, int exc_bits, void* est,
                                   void* non_exc, void* stream) {
  const alp::Alp<double>::Tables t{static_cast<const double*>(exp_tab),
                                   static_cast<const double*>(frac_tab),
                                   static_cast<const long long*>(fact_tab),
                                   magic, upper};
  return launch<double>(samples, ef, ef_per_segment, n_cand, k_count, n, t,
                        exc_bits, est, non_exc, stream);
}

// The f32 twin: samples f32 patterns [n, 32]; the f32 / int32 tables with
// the fact table's length, the magic, float(ENCODING_UPPER_LIMIT) (unused
// by the search) and ENCODING_UPPER_LIMIT as a double, the search's bound.
extern "C" int alp_score_pairs_f32(const void* samples, const void* ef,
                                   int ef_per_segment, int n_cand,
                                   const void* k_count, long long n,
                                   const void* exp_tab, const void* frac_tab,
                                   const void* fact_tab, int fact_len,
                                   float magic, float upper, double limit,
                                   int exc_bits, void* est, void* non_exc,
                                   void* stream) {
  const alp::Alp<float>::Tables t{static_cast<const float*>(exp_tab),
                                  static_cast<const float*>(frac_tab),
                                  static_cast<const int*>(fact_tab),
                                  fact_len, magic, upper, limit};
  return launch<float>(samples, ef, ef_per_segment, n_cand, k_count, n, t,
                       exc_bits, est, non_exc, stream);
}
