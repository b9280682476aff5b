// Hand-written Hopper (sm_90a) key kernels of alp_tpu_torch: the
// predicate and order queries (COUNT WHERE, MIN/MAX, TOP-K, histogram) and
// the rank passes of QUANTILE / MEDIAN.
//
//   K15 key_counts    prefix counts of total-order keys, fused with the
//                     decode.  Replaces, in alp_tpu/kernels/falp.py, the
//                     COUNT kernels falp_decode_f64_variant_count (:890),
//                     falp_decode_f64_count (:1190), falp_decode_f32_count
//                     (:1299), rd_decode_dict_f64_count (:1578) and
//                     rd_decode_dict_f32_count (:2353), and the
//                     multi-threshold prefix counts
//                     falp_decode_f64_variant_prefix_counts (:1112),
//                     rd_decode_dict_f64_prefix_counts (:1677),
//                     falp_decode_f32_prefix_counts (:1788) and
//                     rd_decode_dict_f32_prefix_counts (:1881).
//   K16 key_extremes  the least and the largest key of each vector, fused
//                     with the decode.  Replaces the key-max kernels
//                     falp_decode_f64_variant_keymax (:1052),
//                     rd_decode_dict_f64_keymax (:1624),
//                     falp_decode_f32_keymax (:1746) and
//                     rd_decode_dict_f32_keymax (:1830); their `invert`
//                     (smallest-first TOP-K) is the least key here.
//   K17 rank_pass     one pass of the quantile bisection, fused with the
//                     decode: K15's bins at T thresholds plus, for each of
//                     R brackets [lo_r, hi_r], the least and the largest
//                     key that lies in it.  Replaces the rank-pass kernels
//                     falp_decode_f64_variant_rankpass (:2100),
//                     rd_decode_dict_f64_rankpass (:2160),
//                     falp_decode_f32_rankpass (:2238) and
//                     rd_decode_dict_f32_rankpass (:2295).
//
// Each is one template over the four routes of vector.cuh (ALP f64, ALP
// f32, ALP_RD f64, ALP_RD f32), so twelve C entries.  The TPU kernels
// compare every key with every threshold in their 128 lanes, keep a key
// max per lane column in biased i32 words and leave the exceptions and the
// pad to host corrections; here a key is one unsigned word, the exceptions
// are written in and the pad skipped, so the outputs are final.
//
// The row loop (for_each_row in vector.cuh), shared by the three.  A
// block of T threads (K17 256, K15 and K16 128) walks the rows blockIdx.x,
// + gridDim.x, ... of the bucket; each thread holds 1024 / T values of a
// vector in registers (vector.cuh's register decode straight from the
// staged words), and each exception is patched in by the thread that owns
// its slot, from the row's marks and payloads in shared memory.  The next
// row's words are staged with cp.async while the current row is read; its
// metadata and one exception a thread (slot and payload) are loaded a row
// ahead (vector.cuh's RowAhead), the rare exceptions beyond T a row when
// they are stored, its exception range two rows ahead and its vector id
// three.  A row without exceptions skips the marks.  One barrier a
// vector.  Each kernel hands the loop its work on a thread's keys.  (K15
// and K16 first decoded each vector into shared memory behind 3-5
// barriers, one vector in flight a block, and read it back.)  K15's and
// K16's blocks are held to at least kKeyBlocks = 5 an SM (at most 102
// registers); their block size and register bound were chosen by sweeps
// on the card.
//
// K15.  E ascending thresholds thr_0 < ... < thr_{E-1} (unsigned keys,
// 1 <= E <= kMaxThr); every value that is not pad adds 1 to bin
// p = #{thresholds < key}, and #{key <= thr_e} is the sum of bins 0..e.
// Two kernels, chosen on the host by E:
//  - few thresholds (E <= kSmall = 2: COUNT WHERE, TOP-K's tie count): no
//    search and no shared histogram.  The thresholds, padded to 2 with all
//    ones, are broadcast from shared memory; a thread counts in registers,
//    over all its rows, its keys that are not pad and, for each threshold,
//    its keys above it: a compare and an add a key and threshold, no
//    branch.  At the end the counts are summed across the warp (redux),
//    then across the warps into the block's bins once, which the block
//    adds, where nonzero, into the global int64 bins.  kernel_ablations.py
//    times this path against the tree at E = 2 (k15_tree) and a path of 16
//    thresholds against the tree at E = 7 and 16 (k15_small_16); PERF.md
//    gives the ratios and why kSmall is 2;
//  - many thresholds: K17's search tree (Tree, below: the first
//    min(E, 2047) thresholds in Eytzinger order and a last compare) and a
//    shared histogram of native 32-bit atomics, one atomic for a warp whose
//    lanes fall in one bin (count_bin), flushed as above.
// Dynamic shared memory is sized by E (the tree and the histogram, then
// the loop's payloads, marks and staging buffers), so a small E leaves
// room for more blocks an SM.
//
// K16.  A thread's least and largest key of its 8, then the warp's (redux
// of the 32-bit halves), one pair a warp into a shared slot; after a
// second barrier thread 0 merges the 4 slots and writes the pair at row
// rows[i] of out [n_vectors, 2].  (A merge by warp 0 of the last row's
// slots after the next row's barrier, with no second barrier, was slower:
// warp 0 became the straggler at every barrier; k16_warp_merge.)
//
// K17.  One pass of the bisection: K15's bins at T <= 2048 thresholds and,
// for each of R <= 32 brackets [lo_r, hi_r], the least and the largest key
// inside it, merged into mm [R, 2] with one atomicMin and one atomicMax a
// bracket and block (the caller starts mm at (all ones, 0), so a bracket
// that holds no value of the bucket leaves it untouched).  The first
// design (K15's binning, then 2R compares a value) lost its time to a
// serial binary search of 11 dependent shared loads a value, a match and a
// shared atomic a value, 2R compares and 16 accumulator registers a value,
// 4 blocks an SM and a shared-memory round trip of every value behind 3
// barriers.  The present design:
//  - the search: each block lays the first min(T, 2047) thresholds out in
//    Eytzinger (breadth-first) order in shared memory (Tree, below), and
//    a thread walks its 4 keys through the L levels in lockstep: 4
//    independent chains of branch-free steps, whose top levels are the
//    same few addresses for every lane.  (A two-level guide of slots
//    linear in the key, with sub-slots for the full ones, needs 2-3 reads
//    a key instead of 11, but measured no faster on the card: its reads
//    are as random as the tree's deep levels, its search loop diverges,
//    and its 16-24 KB more of shared memory cost a block an SM);
//  - the bins: K15's many-threshold bins (count_bin);
//  - the brackets: equal brackets are merged (a first pass has R equal
//    ones), and their ends lo - 1 and hi (at most 2R cut points) split the
//    keys into intervals that lie wholly inside or outside each bracket.
//    A key outside the brackets' union [min lo, max hi] (two compares in
//    registers) is in none; one inside reads its bin's first interval and
//    the count of cuts that split the bin, compares itself with those cuts
//    (a later pass's bins between two brackets hold two) and takes its
//    interval's bracket mask: no bracket's ends are compared with every
//    value.  Each warp keeps its least and largest key a bracket in shared
//    slots [8][R]: a key only reads its bracket's slots, and where it
//    moves one, the lanes of that bracket reduce their keys and one
//    writes (no atomics, no register a bracket: per-thread slots took 32
//    KB and per-thread registers 16-32 more registers a thread, each a
//    block an SM).  The bracket tables (the brackets, the slots, the cuts
//    and their masks) lie in the dynamic shared memory sized by the
//    launch's R, as the tree is sized by T: a pass of few brackets (MEDIAN:
//    2) holds only its own, and only a wide pass (up to 32 brackets:
//    sixteen quantiles in one bisection) pays for its slots;
//  - the row loop above.
//
// What still keeps them from their bounds (kernel_ablations.py on the
// card): K16 and K15's few-threshold path are little more than the row
// loop (k15_no_bins), whose exception marks and payloads take about a
// third of their time, as much on the bw-0 column, which holds none,
// through the registers the patch path holds (keys_no_exceptions), and
// whose decode about a quarter (keys_no_decode); the warps of a block meet
// at a barrier once a vector (K16 twice).  K15's many-threshold path and
// K17 add the tree's deep levels, the bin and the bin's interval, random
// shared addresses, so that a warp's loads split into several bank
// wavefronts.
//
// Bound.  All three read only the packed words, the metadata, the row ids
// and the exceptions of their vectors (a few bits a value) and write a few
// bins or keys, so they are bound by operations: the decode's (K1-K4's
// unpack, FOR add, FACT product, conversion and product, or the RD glue),
// about 3 for the key, then ceil(log2(E + 1)) search steps (K15, K17) and
// 2 compares (K16).  K17's bracket work follows its algorithm on the
// run's data: the union test, a key's bin interval and bracket mask, a
// compare a cut that splits its bin and a min and a max a bracket that
// holds it, at the INT32 issue rate.
// chip_smoke.py counts them (KEY_OPS, RANK_OPS, and beside them the count
// of K17's first design: ceil(log2(E + 1)) search steps and 2R compares a
// value).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "vector.cuh"

namespace {

using alp::bad_alp;
using alp::bad_rd;
using alp::for_each_row;
using alp::kVector;
using alp::launch_rows;
using alp::merge_key;
using alp::peer_extremes;
using alp::round16;
using alp::row_layout;
using alp::RowLayout;
using alp::start_rows;
using alp::umax;
using alp::umin;
using alp::warp_extremes;
constexpr int kThreads = 256;                // K17's block
constexpr int kPer = kVector / kThreads;     // values of a vector a thread
constexpr int kWarps = kThreads / 32;
constexpr int kKeyThreads = 128;             // K15's and K16's block
constexpr int kKeyBlocks = 5;                // ... resident an SM, at least
constexpr int kKeyPer = kVector / kKeyThreads;
constexpr int kKeyWarps = kKeyThreads / 32;
constexpr int kMaxThr = 2048;
constexpr int kMaxRanks = 32;                // a bit of a mask a bracket
constexpr int kSmall = 2;                    // K15 without a search: E <= 2
constexpr unsigned kFull = alp::kFullMask;

// ---------------------------------------------------------------------------
// K15 and K17's bins
// ---------------------------------------------------------------------------

// The search tree: the first min(E, kTree) thresholds in Eytzinger
// (breadth-first) order at nodes 1 .. 2^L - 1 of tree[], padded with all
// ones (never below a key), so every lane of a warp reads the same node at
// the root and one of 2^d nodes at depth d.  L levels of
// at = 2 at + (tree[at] < key) leave #{thresholds < key} = at - 2^L; at
// E = 2048 one compare with the last threshold adds the 2048th.  A thread
// walks its keys through the levels in lockstep: independent chains of
// shared loads.
constexpr int kTree = kMaxThr - 1;

inline int tree_levels(int E) {
  const int tree = E < kTree ? E : kTree;
  int levels = 0;
  while ((1 << levels) - 1 < tree) ++levels;
  return levels;
}

template <typename U>
struct Tree {
  const U* node;
  int L;
  bool extra;                                // E = 2048: the last compare
  U last;

  // Every thread of the block calls it; the caller syncs before use.
  __device__ __forceinline__ void build(U* w, const U* __restrict__ thr,
                                        int E) const {
    const int n = E < kTree ? E : kTree;
    for (int at = threadIdx.x + 1; at < (1 << L); at += blockDim.x) {
      const int d = 31 - __clz(at);          // depth of node `at`
      const int s = ((2 * (at - (1 << d)) + 1) << (L - 1 - d)) - 1;
      w[at] = s < n ? thr[s] : static_cast<U>(~U(0));
    }
  }

  // #{thresholds < key} for N keys of a thread
  template <int N>
  __device__ __forceinline__ void bins(const U (&key)[N],
                                       int (&p)[N]) const {
    int at[N];
#pragma unroll
    for (int j = 0; j < N; ++j) at[j] = 1;
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        at[j] = 2 * at[j] + (node[at[j]] < key[j]);
    }
#pragma unroll
    for (int j = 0; j < N; ++j)
      p[j] = at[j] - (1 << L) + (extra && last < key[j]);
  }
};

// Count one bin a lane (none where `real` is false); every lane of the
// warp calls it together.  A warp whose lanes all fall in one bin adds 32
// with one atomic; otherwise each lane adds 1 (native 32-bit shared
// atomics, no match).
__device__ __forceinline__ void count_bin(bool real, int p, unsigned* hist) {
  const int q = real ? p : -1;
  const int q0 = __shfl_sync(kFull, q, 0);
  if (__all_sync(kFull, q == q0)) {
    if ((threadIdx.x & 31) == 0 && q0 >= 0) atomicAdd(&hist[q0], 32u);
  } else if (q >= 0) {
    atomicAdd(&hist[q], 1u);
  }
}

// The block's nonzero bins into the global int64 bins; after a barrier
// (K15's many-threshold path and K17).
__device__ __forceinline__ void flush_bins(const unsigned* hist, int E,
                                           unsigned long long* bins) {
  for (int j = threadIdx.x; j <= E; j += blockDim.x)
    if (hist[j]) atomicAdd(&bins[j], static_cast<unsigned long long>(hist[j]));
}

// ---------------------------------------------------------------------------
// K15
// ---------------------------------------------------------------------------

// The few-threshold count of a thread's keys: above[0] the keys that are
// not pad, above[e + 1] those above threshold th[e] (th padded with all
// ones, which no key is above; a pad key counts as 0, which is above none).
template <int N, typename U>
__device__ __forceinline__ void count_small(unsigned (&above)[kSmall + 1],
                                            const U* th, const U (&key)[N],
                                            const bool (&real)[N]) {
  U k[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    k[j] = real[j] ? key[j] : U(0);
    above[0] += real[j];
  }
#pragma unroll
  for (int e = 0; e < kSmall; ++e) {
    const U t = th[e];
#pragma unroll
    for (int j = 0; j < N; ++j) above[e + 1] += k[j] > t;
  }
}

// K15 at E <= kSmall thresholds: the counts in registers, no search.
template <class V>
__global__ void __launch_bounds__(kKeyThreads, kKeyBlocks)
key_counts_small_kernel(V src, const long long* __restrict__ rows,
                        long long n, long long n_values,
                        const typename V::U* __restrict__ thr, int E,
                        RowLayout lay,
                        unsigned long long* __restrict__ bins) {
  using U = typename V::U;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ U th[kSmall];
  __shared__ unsigned part[kKeyWarps][kSmall + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  start_rows<kKeyThreads>(src, n, dyn, lay);
  if (tid < kSmall) th[tid] = tid < E ? thr[tid] : static_cast<U>(~U(0));
  __syncthreads();
  unsigned above[kSmall + 1];
#pragma unroll
  for (int e = 0; e <= kSmall; ++e) above[e] = 0;
  for_each_row<kKeyThreads>(src, rows, n, n_values, dyn, lay,
                            [&](long long, const U (&key)[kKeyPer],
                                const bool (&real)[kKeyPer]) {
    count_small(above, th, key, real);
  });
  // the warp's counts, then the block's: bin p holds the keys above
  // thr_{p-1} (all of them for p = 0) less those above thr_p
#pragma unroll
  for (int e = 0; e <= kSmall; ++e)
    above[e] = __reduce_add_sync(kFull, above[e]);
  if (lane == 0) {
#pragma unroll
    for (int e = 0; e <= kSmall; ++e) part[warp][e] = above[e];
  }
  __syncthreads();
  if (tid <= E) {
    unsigned a = 0, b = 0;
    for (int w = 0; w < kKeyWarps; ++w) {
      a += part[w][tid];
      b += tid < E ? part[w][tid + 1] : 0u;
    }
    if (a != b) atomicAdd(&bins[tid], static_cast<unsigned long long>(a - b));
  }
}

// K15 at more thresholds: the dynamic shared memory's byte offsets (the
// tree at 0, then the histogram and the row loop's).
struct CountLayout {
  int levels;                                // L
  unsigned hist;
  RowLayout rows;
};

inline CountLayout count_layout(int E, unsigned key_bytes, int staged) {
  CountLayout l{};
  l.levels = tree_levels(E);
  l.hist = round16((1u << l.levels) * key_bytes);
  l.rows = row_layout(l.hist + (E + 1) * 4u, key_bytes, staged);
  return l;
}

// The many-threshold count of a thread's keys: their bins, then the
// block's histogram.
template <int N, typename U>
__device__ __forceinline__ void count_tree(const Tree<U>& tr, unsigned* hist,
                                           const U (&key)[N],
                                           const bool (&real)[N]) {
  int p[N];
  tr.bins(key, p);
#pragma unroll
  for (int j = 0; j < N; ++j) count_bin(real[j], p[j], hist);
}

// K15 at kSmall < E <= kMaxThr thresholds: the search tree.
template <class V>
__global__ void __launch_bounds__(kKeyThreads, kKeyBlocks)
key_counts_kernel(V src, const long long* __restrict__ rows, long long n,
                  long long n_values, const typename V::U* __restrict__ thr,
                  int E, CountLayout lay,
                  unsigned long long* __restrict__ bins) {
  using U = typename V::U;
  extern __shared__ __align__(16) unsigned char dyn[];
  U* tree = reinterpret_cast<U*>(dyn);
  unsigned* hist = reinterpret_cast<unsigned*>(dyn + lay.hist);
  start_rows<kKeyThreads>(src, n, dyn, lay.rows);
  const Tree<U> tr{tree, lay.levels, E > kTree, thr[E - 1]};
  tr.build(tree, thr, E);
  for (int j = threadIdx.x; j <= E; j += kKeyThreads) hist[j] = 0;
  __syncthreads();
  for_each_row<kKeyThreads>(src, rows, n, n_values, dyn, lay.rows,
                            [&](long long, const U (&key)[kKeyPer],
                                const bool (&real)[kKeyPer]) {
    count_tree(tr, hist, key, real);
  });
  __syncthreads();
  flush_bins(hist, E, bins);
}

// ---------------------------------------------------------------------------
// K16
// ---------------------------------------------------------------------------

// K16: (least key, largest key) of each vector into out[rows[i]].
template <class V>
__global__ void __launch_bounds__(kKeyThreads, kKeyBlocks)
key_extremes_kernel(V src, const long long* __restrict__ rows, long long n,
                    long long n_values, RowLayout lay,
                    typename V::U* __restrict__ out) {
  using U = typename V::U;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ U wlo[kKeyWarps], whi[kKeyWarps];   // a warp's pair
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  start_rows<kKeyThreads>(src, n, dyn, lay);
  __syncthreads();
  for_each_row<kKeyThreads>(src, rows, n, n_values, dyn, lay,
                            [&](long long vec, const U (&key)[kKeyPer],
                                const bool (&real)[kKeyPer]) {
    U lo = static_cast<U>(~U(0)), hi = 0;
#pragma unroll
    for (int j = 0; j < kKeyPer; ++j) {
      if (real[j]) {
        lo = umin(lo, key[j]);
        hi = umax(hi, key[j]);
      }
    }
    warp_extremes(lo, hi);
    if (lane == 0) {
      wlo[warp] = lo;
      whi[warp] = hi;
    }
    // the slots are written again only after the next row's barrier
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kKeyWarps; ++w) {
        lo = umin(lo, wlo[w]);
        hi = umax(hi, whi[w]);
      }
      out[2 * vec] = lo;
      out[2 * vec + 1] = hi;
    }
  });
}

// ---------------------------------------------------------------------------
// K17
// ---------------------------------------------------------------------------

// A bin's first cut interval and its count of cuts share a uint16 (qbin);
// a bracket is one bit of a 32-bit mask.
static_assert(2 * kMaxRanks < 256 && kMaxRanks <= 32, "K17's masks");

// K17's dynamic shared memory: the tree at 0, then these byte offsets and
// the row loop's.  The bracket tables are sized by R: the brackets' ends
// blo, bhi [R], the warps' slots wlo, whi [kWarps][R] (keys), the cuts ct
// [2R] (keys), their masks cmask [2R + 1] and first [R].
struct RankLayout {
  int levels;                                // L
  unsigned hist, qbin, blo, bhi, wlo, whi, ct, cmask, first;
  RowLayout rows;
};

inline RankLayout rank_layout(int E, int R, unsigned key_bytes, int staged) {
  RankLayout l{};
  l.levels = tree_levels(E);
  l.hist = round16((1u << l.levels) * key_bytes);
  l.qbin = round16(l.hist + (E + 1) * 4u);
  l.blo = round16(l.qbin + (E + 1u) * 2u);
  l.bhi = l.blo + R * key_bytes;
  l.wlo = l.bhi + R * key_bytes;
  l.whi = l.wlo + kWarps * R * key_bytes;
  l.ct = l.whi + kWarps * R * key_bytes;
  l.cmask = l.ct + 2 * R * key_bytes;
  l.first = l.cmask + (2 * R + 1) * 4u;
  l.rows = row_layout(l.first + R * 4u, key_bytes, staged);
  return l;
}

// #{cuts < key}: the key's interval of the n ascending bracket cut points
// ct (a binary search; only the tables' set-up calls it).
template <typename U>
__device__ __forceinline__ int cut_interval(const U* ct, int n, U key) {
  int q = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (ct[q + half] < key) {
      q += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return q;
}

// The brackets of bit mask m hold the key (none where m is 0): the
// warp's slots wlo[b], whi[b] of each take it.  A lane reads its
// bracket's slots; only where the key moves one do the lanes of that
// bracket (a match) reduce their keys, and the first of them writes: a
// slot has one writer at a time, so no atomics.  In random data the slots
// settle after a few vectors; ordered data reduce once a warp and bracket.
// Every lane of the warp calls it together.
template <typename U>
__device__ __forceinline__ void bracket_key(U key, unsigned m, U* wlo,
                                            U* whi) {
  const volatile U* vlo = wlo;
  const volatile U* vhi = whi;
  while (__any_sync(kFull, m != 0)) {
    const int b = m ? __ffs(m) - 1 : -1;
    m &= m - 1;
    const bool moves = b >= 0 && (key < vlo[b] || key > vhi[b]);
    if (__any_sync(kFull, moves)) {
      const unsigned peers = __match_any_sync(kFull, moves ? b : -1);
      if (moves) {
        U lo, hi;
        peer_extremes(peers, key, lo, hi);
        if ((threadIdx.x & 31) == __ffs(peers) - 1) {
          if (lo < vlo[b]) wlo[b] = lo;
          if (hi > vhi[b]) whi[b] = hi;
        }
      }
      __syncwarp();
    }
  }
}

// The block's shared tables of K17
template <typename U>
struct RankTables {
  Tree<U> tree;
  unsigned* hist;
  const uint16_t* qbin;                      // bin -> first interval, cuts
  const U* ct;
  const unsigned* cmask;                     // cut interval -> brackets
  U ulo, uhi;                                // the brackets' union
  U* wlo;                                    // the warp's slots
  U* whi;
};

// N keys of a thread: their bins, then their brackets.  A key outside
// [ulo, uhi] is in no bracket; one inside reads its bin's first interval,
// compares itself with the cuts inside the bin and takes its interval's
// bracket mask.  Every lane of the warp calls it together.
template <int N, typename U>
__device__ __forceinline__ void rank_keys(const U (&key)[N],
                                          const bool (&real)[N],
                                          const RankTables<U>& t) {
  int p[N];
  unsigned m[N];
  t.tree.bins(key, p);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    m[j] = 0;
    count_bin(real[j], p[j], t.hist);
    if (real[j] && key[j] >= t.ulo && key[j] <= t.uhi) {
      // the bin's first interval, plus the cuts inside it below the key
      const unsigned qb = t.qbin[p[j]];
      int q = qb & 0xffu;
      for (int c = q, e = q + (qb >> 8); c < e; ++c) q += t.ct[c] < key[j];
      m[j] = t.cmask[q];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) bracket_key(key[j], m[j], t.wlo, t.whi);
}

// K17: K15's bins of rows 0..n-1 at E thresholds, and for each of the R
// brackets br[2r] <= key <= br[2r + 1] the least and largest key in it,
// merged into mm[2r], mm[2r + 1].
template <class V>
__global__ void __launch_bounds__(kThreads)
rank_pass_kernel(V src, const long long* __restrict__ rows, long long n,
                 long long n_values, const typename V::U* __restrict__ thr,
                 int E, const typename V::U* __restrict__ br, int R,
                 RankLayout lay, unsigned long long* __restrict__ bins,
                 typename V::U* __restrict__ mm) {
  using U = typename V::U;
  extern __shared__ __align__(16) unsigned char dyn[];
  U* tree = reinterpret_cast<U*>(dyn);
  unsigned* hist = reinterpret_cast<unsigned*>(dyn + lay.hist);
  uint16_t* qbin = reinterpret_cast<uint16_t*>(dyn + lay.qbin);
  U* blo = reinterpret_cast<U*>(dyn + lay.blo);
  U* bhi = reinterpret_cast<U*>(dyn + lay.bhi);
  U* wlo = reinterpret_cast<U*>(dyn + lay.wlo);   // warp w's at w * R
  U* whi = reinterpret_cast<U*>(dyn + lay.whi);
  U* ct = reinterpret_cast<U*>(dyn + lay.ct);
  unsigned* cmask = reinterpret_cast<unsigned*>(dyn + lay.cmask);
  int* first = reinterpret_cast<int*>(dyn + lay.first);  // r's first equal
  __shared__ int n_cuts;
  __shared__ U ulo, uhi;
  const int tid = threadIdx.x, warp = tid >> 5;
  const U top = static_cast<U>(~U(0));
  start_rows<kThreads>(src, n, dyn, lay.rows);
  // the tree, the bins, the brackets and the slots, while the first row's
  // words arrive
  const Tree<U> tr{tree, lay.levels, E > kTree, thr[E - 1]};
  tr.build(tree, thr, E);
  for (int j = tid; j <= E; j += kThreads) hist[j] = 0;
  for (int j = tid; j < kWarps * R; j += kThreads) {
    wlo[j] = top;
    whi[j] = 0;
  }
  if (tid < R) {
    blo[tid] = br[2 * tid];
    bhi[tid] = br[2 * tid + 1];
  }
  __syncthreads();
  if (tid < R) {
    int f = tid;
    for (int r = tid - 1; r >= 0; --r)
      if (blo[r] == blo[tid] && bhi[r] == bhi[tid]) f = r;
    first[tid] = f;
  }
  __syncthreads();
  // the cut points: lo - 1 and hi of every distinct bracket that holds a
  // key, ascending and distinct; every interval between two of them lies
  // wholly inside or outside each bracket
  if (tid == 0) {
    int nc = 0;
    U lo = top, hi = 0;
    for (int r = 0; r < R; ++r) {
      if (first[r] != r || blo[r] > bhi[r]) continue;
      lo = umin(lo, blo[r]);
      hi = umax(hi, bhi[r]);
      if (blo[r] > 0) ct[nc++] = blo[r] - 1;
      if (bhi[r] < top) ct[nc++] = bhi[r];
    }
    for (int a = 1; a < nc; ++a)             // insertion sort, <= 2R cuts
      for (int b = a; b > 0 && ct[b] < ct[b - 1]; --b) {
        const U x = ct[b];
        ct[b] = ct[b - 1];
        ct[b - 1] = x;
      }
    int d = 0;
    for (int a = 0; a < nc; ++a)
      if (d == 0 || ct[a] != ct[d - 1]) ct[d++] = ct[a];
    n_cuts = d;
    ulo = lo;
    uhi = hi;
  }
  __syncthreads();
  const int ncut = n_cuts;
  // interval q holds the keys in [lower, upper]: each bracket holds all
  // of it or none
  if (tid <= ncut) {
    const U lower = tid == 0 ? U(0) : static_cast<U>(ct[tid - 1] + 1);
    const U upper = tid == ncut ? top : ct[tid];
    unsigned m = 0;
    for (int r = 0; r < R; ++r)
      if (first[r] == r && blo[r] <= bhi[r] && lower >= blo[r] &&
          upper <= bhi[r])
        m |= 1u << r;
    cmask[tid] = m;
  }
  // bin p holds the keys in [lower, upper] = (thr[p - 1], thr[p]]: its
  // first cut interval and the number of cuts that split it (low and high
  // byte); a later pass's bins between two brackets hold two cuts
  for (int p = tid; p <= E; p += kThreads) {
    const U lower = p > 0 ? static_cast<U>(thr[p - 1] + (thr[p - 1] < top))
                          : U(0);
    const U upper = p < E ? thr[p] : top;
    const int ql = cut_interval(ct, ncut, lower);
    const int qu = cut_interval(ct, ncut, upper);
    qbin[p] = static_cast<uint16_t>(ql | (lower <= upper ? (qu - ql) << 8
                                                         : 0));
  }
  const RankTables<U> tab{tr, hist, qbin, ct, cmask, ulo, uhi, wlo + warp * R,
                          whi + warp * R};
  for_each_row<kThreads>(src, rows, n, n_values, dyn, lay.rows,
                         [&](long long, const U (&key)[kPer],
                             const bool (&real)[kPer]) {
    rank_keys(key, real, tab);
  });
  __syncthreads();
  flush_bins(hist, E, bins);
  // thread r merges the warps' slots of bracket r (the first of its
  // equals)
  if (tid < R) {
    U l = top, h = 0;
    for (int w = 0; w < kWarps; ++w) {
      l = umin(l, wlo[w * R + first[tid]]);
      h = umax(h, whi[w * R + first[tid]]);
    }
    if (l <= h) merge_key(mm + 2 * tid, l, h);  // else: none in the bracket
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// K15 over a bucket, 1 <= E <= kMaxThr: the few-threshold kernel or the
// search tree.
template <class V>
int launch_counts(const V& src, const void* rows, long long n,
                  long long n_values, const void* thr, int E, void* bins,
                  int dev, void* stream) {
  using U = typename V::U;
  if (n < 0 || n_values < 0 || E < 1 || E > kMaxThr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* r = static_cast<const long long*>(rows);
  const auto* t = static_cast<const U*>(thr);
  auto* b = static_cast<unsigned long long*>(bins);
  if (E <= kSmall) {
    const RowLayout lay = row_layout(0, sizeof(U), src.staged_bytes());
    return launch_rows<kKeyThreads>(key_counts_small_kernel<V>, n, lay.bytes,
                                    dev, stream, src, r, n, n_values, t, E,
                                    lay, b);
  }
  const CountLayout lay = count_layout(E, sizeof(U), src.staged_bytes());
  return launch_rows<kKeyThreads>(key_counts_kernel<V>, n, lay.rows.bytes,
                                  dev, stream, src, r, n, n_values, t, E,
                                  lay, b);
}

// K16 over a bucket.
template <class V>
int launch_extremes(const V& src, const void* rows, long long n,
                    long long n_values, void* out, int dev, void* stream) {
  using U = typename V::U;
  if (n < 0 || n_values < 0) return static_cast<int>(cudaErrorInvalidValue);
  const RowLayout lay = row_layout(0, sizeof(U), src.staged_bytes());
  return launch_rows<kKeyThreads>(key_extremes_kernel<V>, n, lay.bytes, dev,
                                  stream, src,
                                  static_cast<const long long*>(rows), n,
                                  n_values, lay, static_cast<U*>(out));
}

// K17 over a bucket: 1 <= E <= kMaxThr thresholds, 1 <= R <= kMaxRanks
// brackets.
template <class V>
int launch_rank(const V& src, const void* rows, long long n,
                long long n_values, const void* thr, int E, const void* br,
                int R, void* bins, void* mm, int dev, void* stream) {
  using U = typename V::U;
  if (n < 0 || n_values < 0 || E < 1 || E > kMaxThr || R < 1 ||
      R > kMaxRanks)
    return static_cast<int>(cudaErrorInvalidValue);
  const RankLayout lay = rank_layout(E, R, sizeof(U), src.staged_bytes());
  return launch_rows<kThreads>(rank_pass_kernel<V>, n, lay.rows.bytes, dev,
                               stream, src,
                               static_cast<const long long*>(rows), n,
                               n_values, static_cast<const U*>(thr), E,
                               static_cast<const U*>(br), R, lay,
                               static_cast<unsigned long long*>(bins),
                               static_cast<U*>(mm));
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers on card
// `dev`, which the caller has made current.  ALP entries take K1/K2's
// bucket arguments and the plan's ALP exception CSR (exc_bits: true
// bits); RD entries K3/K4's and the RD exception CSR (exc_left: raw left
// parts).  K15 adds into bins (int64 [E + 1]); thr holds E ascending
// unsigned keys (uint64 for f64, uint32 for f32), 1 <= E <= 2048.  K16
// writes out (keys, [n_vectors, 2]) at rows rows[i].  K17 adds into bins
// as K15 and merges into mm (keys, [R, 2]) the least and largest key in
// each bracket of br (keys, [R, 2]: lo, hi), 1 <= R <= 32.  Every entry
// returns cudaGetLastError() (or the error of its device query).

extern "C" int alp_key_counts_alp_f64(ALP_ARGS, const void* thr, int E,
                                      void* bins, int dev, void* stream) {
  if (bad_alp(bw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_counts(ALP_ROUTE(double), rows, n, n_values, thr, E, bins,
                       dev, stream);
}

extern "C" int alp_key_counts_alp_f32(ALP_ARGS, const void* thr, int E,
                                      void* bins, int dev, void* stream) {
  if (bad_alp(bw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_counts(ALP_ROUTE(float), rows, n, n_values, thr, E, bins,
                       dev, stream);
}

extern "C" int alp_key_counts_rd_f64(RD_ARGS, const void* thr, int E,
                                     void* bins, int dev, void* stream) {
  if (bad_rd(rbw, lbw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_counts(RD_ROUTE(uint64_t, 64), rows, n, n_values, thr, E,
                       bins, dev, stream);
}

extern "C" int alp_key_counts_rd_f32(RD_ARGS, const void* thr, int E,
                                     void* bins, int dev, void* stream) {
  if (bad_rd(rbw, lbw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_counts(RD_ROUTE(uint32_t, 32), rows, n, n_values, thr, E,
                       bins, dev, stream);
}

extern "C" int alp_key_extremes_alp_f64(ALP_ARGS, void* out, int dev,
                                        void* stream) {
  if (bad_alp(bw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_extremes(ALP_ROUTE(double), rows, n, n_values, out, dev,
                         stream);
}

extern "C" int alp_key_extremes_alp_f32(ALP_ARGS, void* out, int dev,
                                        void* stream) {
  if (bad_alp(bw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_extremes(ALP_ROUTE(float), rows, n, n_values, out, dev,
                         stream);
}

extern "C" int alp_key_extremes_rd_f64(RD_ARGS, void* out, int dev,
                                       void* stream) {
  if (bad_rd(rbw, lbw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_extremes(RD_ROUTE(uint64_t, 64), rows, n, n_values, out, dev,
                         stream);
}

extern "C" int alp_key_extremes_rd_f32(RD_ARGS, void* out, int dev,
                                       void* stream) {
  if (bad_rd(rbw, lbw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_extremes(RD_ROUTE(uint32_t, 32), rows, n, n_values, out, dev,
                         stream);
}

extern "C" int alp_rank_pass_alp_f64(ALP_ARGS, const void* thr, int E,
                                     const void* br, int R, void* bins,
                                     void* mm, int dev, void* stream) {
  if (bad_alp(bw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rank(ALP_ROUTE(double), rows, n, n_values, thr, E, br, R,
                     bins, mm, dev, stream);
}

extern "C" int alp_rank_pass_alp_f32(ALP_ARGS, const void* thr, int E,
                                     const void* br, int R, void* bins,
                                     void* mm, int dev, void* stream) {
  if (bad_alp(bw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rank(ALP_ROUTE(float), rows, n, n_values, thr, E, br, R,
                     bins, mm, dev, stream);
}

extern "C" int alp_rank_pass_rd_f64(RD_ARGS, const void* thr, int E,
                                    const void* br, int R, void* bins,
                                    void* mm, int dev, void* stream) {
  if (bad_rd(rbw, lbw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rank(RD_ROUTE(uint64_t, 64), rows, n, n_values, thr, E, br,
                     R, bins, mm, dev, stream);
}

extern "C" int alp_rank_pass_rd_f32(RD_ARGS, const void* thr, int E,
                                    const void* br, int R, void* bins,
                                    void* mm, int dev, void* stream) {
  if (bad_rd(rbw, lbw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rank(RD_ROUTE(uint32_t, 32), rows, n, n_values, thr, E, br,
                     R, bins, mm, dev, stream);
}
