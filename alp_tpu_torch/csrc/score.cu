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
// and up to ~10.5 M.
//
// Design.  One thread a (segment, candidate) task: the thread keeps its
// pair's constants, the running max, min and count in registers and walks
// the segment's 32 samples (unrolled by 4, so that the trials' FP64 and
// conversion chains overlap), with no shuffle and no ballot.  A block takes
// `segs` consecutive segments, as many as fill ~kBlock threads with their
// tasks where the pairs are shared and ~kBlockOwn where each segment has
// its own (at least 1 and at most kMaxSegs): the first planning level (C =
// 190 f64 / 66 f32 shared pairs) one or three segments a block, the
// second (C = 5 pairs of each segment's own, many past its k_count) 25,
// smaller blocks that spread its idle candidates over more SMs.  The
// block stages its segments' samples into shared memory once, with
// coalesced loads, at a stride of 33 so that the threads of a warp, which
// read sample i of up to 7 segments at once, hit distinct banks; the
// threads of one segment read the same address, a broadcast.  Task t of a
// block is (t / C, t % C): one 32-bit division a task.  The first design
// (one warp a task, one sample a lane, a 64-bit task / C, and ten 64-bit
// shuffles, a ballot and a popc a task) spent as many instructions on the
// task as on its trial; kernel_ablations.py times it (k11_warp_task).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "encode.cuh"

namespace {

constexpr int kBlock = 256;      // the tasks a block aims at: shared pairs
constexpr int kBlockOwn = 128;   // and each segment's own
constexpr int kSamples = 32;
constexpr int kStride = kSamples + 1;   // a segment's samples in shared memory
constexpr int kMaxSegs = 64;     // segments a block at most

template <typename F>
__global__ void __launch_bounds__(kBlock)
score_kernel(const typename alp::Alp<F>::U* __restrict__ samples,
             const int* __restrict__ ef, int ef_per_segment, int n_cand,
             const int* __restrict__ k_count, int n, int segs,
             typename alp::Alp<F>::Tables t, int exc_bits,
             int* __restrict__ est, int* __restrict__ non_exc) {
  using A = alp::Alp<F>;
  using U = typename A::U;
  using I = typename A::I;
  __shared__ U smp[kMaxSegs * kStride];
  const int seg0 = blockIdx.x * segs;
  const int m = min(segs, n - seg0);         // this block's segments
  const U* src = samples + static_cast<long long>(seg0) * kSamples;
  for (int i = threadIdx.x; i < m * kSamples; i += blockDim.x)
    smp[(i / kSamples) * kStride + i % kSamples] = src[i];
  __syncthreads();
  for (int task = threadIdx.x; task < m * n_cand; task += blockDim.x) {
    const int sl = task / n_cand, c = task - sl * n_cand;
    const long long at = static_cast<long long>(seg0 + sl) * n_cand + c;
    if (k_count && c >= k_count[seg0 + sl]) {
      est[at] = non_exc[at] = 0;
      continue;
    }
    const int* pair = ef + 2 * (ef_per_segment ? at : c);
    const typename A::Pair p = A::pair_of(t, pair[0], pair[1]);
    const U* s = smp + sl * kStride;
    I mx = A::kMin, mn = A::kMax;
    int ne = 0;
#pragma unroll 4
    for (int i = 0; i < kSamples; ++i) {
      const alp::Encoded<I> enc = A::search(s[i], p, t);
      mx = enc.exc ? mx : max(mx, enc.n);
      mn = enc.exc ? mn : min(mn, enc.n);
      ne += !enc.exc;
    }
    est[at] = kSamples * A::width(mx, mn) + (kSamples - ne) * exc_bits;
    non_exc[at] = ne;
  }
}

template <typename F>
int launch(const void* samples, const void* ef, int ef_per_segment,
           int n_cand, const void* k_count, long long n,
           const typename alp::Alp<F>::Tables& t, int exc_bits, void* est,
           void* non_exc, void* stream) {
  if (n < 0 || n > INT_MAX || n_cand < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int aim = ef_per_segment ? kBlockOwn : kBlock;
  const int segs = max(1, min(aim / n_cand, kMaxSegs));
  const int threads = min(aim, (segs * n_cand + 31) / 32 * 32);
  if (n)
    score_kernel<F><<<static_cast<unsigned>((n + segs - 1) / segs), threads,
                      0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const typename alp::Alp<F>::U*>(samples),
        static_cast<const int*>(ef), ef_per_segment, n_cand,
        static_cast<const int*>(k_count), static_cast<int>(n), segs, t,
        exc_bits, static_cast<int*>(est), static_cast<int*>(non_exc));
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
