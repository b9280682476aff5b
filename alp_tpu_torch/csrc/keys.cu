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
// f32, ALP_RD f64, ALP_RD f32), so twelve C entries.
//
// K15.  E ascending thresholds thr_0 < ... < thr_{E-1} (unsigned keys; E
// at most kMaxThr, which keeps a block's static shared memory under
// 48 KB).  Every value of the bucket that is not pad adds 1 to bin
// p = #{thresholds < key}, found by a binary search in shared memory; the
// warp's lanes that share a bin add to the block's shared histogram with
// one atomic (__match_any_sync), and each block adds its nonzero bins to
// the global int64 [E + 1] bins once.  #{key <= thr_e} is the sum of bins
// 0..e.  The TPU kernels instead compare every key with every threshold
// in its 128 lanes and leave the exceptions and the pad to host
// corrections; here the exceptions are written in and the pad skipped, so
// the counts are final.
//
// K16.  A thread's least and largest key over its values, then warp
// shuffles, one shared row a block, and thread 0 writes the pair at row
// rows[i] of out [n_vectors, 2].  The TPU kernels keep a key max per lane
// column of 128 lanes in biased i32 words; Hopper compares 64-bit
// integers, so the key is one unsigned word.
//
// K17.  One pass of the bisection: K15's bins at T <= 2048 thresholds and,
// for each of R <= 8 brackets [lo_r, hi_r], the least and the largest key
// inside it, merged into mm [R, 2] with one atomicMin and one atomicMax a
// bracket and block (the caller starts mm at (all ones, 0), so a bracket
// that holds no value of the bucket leaves it untouched).  The TPU kernels
// split each key into two biased i32 words and compare them
// lexicographically per lane; here a key is one unsigned word.  The first
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
//  - the bins: native 32-bit shared atomics, no match; a warp whose 32
//    lanes fall in one bin (the bw-0 column) adds 32 with one atomic;
//  - the brackets: equal brackets are merged (a first pass has R equal
//    ones), and their ends lo - 1 and hi (at most 16 cut points) split the
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
//    block an SM);
//  - the round trip: the values stay in registers (vector.cuh's register
//    decode straight from the staged words), and each exception is patched
//    in by the thread that owns its slot, from the row's marks and
//    payloads in shared memory, so no second pass ranks the exceptions.
//    The next row's words are staged with cp.async while the current row
//    is ranked; its metadata, exception slots and payloads are loaded a
//    row ahead (vector.cuh's RowAhead), its exception range two rows and
//    its vector id three: no load of global memory waits inside a row.
//    One barrier a vector.
// What still keeps it from its bound: the deep levels of the tree, the bin
// and the bin's interval are random shared addresses, so a warp's loads
// split into several bank wavefronts, and the warps of a block meet at a
// barrier once a vector.
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
// of the first design: ceil(log2(E + 1)) search steps and 2R compares a
// value).  K15 and K16 keep the first, simple design: one block of 256
// threads walks the vectors of its share, and each vector is decoded into
// shared memory (vector.cuh's decode) before it is read.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "vector.cuh"

namespace {

using alp::AlpVector;
using alp::bad_alp;
using alp::bad_rd;
using alp::commit_async;
using alp::grid_for;
using alp::kMarks;
using alp::kVector;
using alp::mark_slots;
using alp::merge_key;
using alp::order_key;
using alp::peer_extremes;
using alp::RdVector;
using alp::round16;
using alp::RowAhead;
using alp::stage_layout;
using alp::umax;
using alp::umin;
using alp::wait_async;
using alp::warp_max;
using alp::warp_min;
constexpr int kThreads = 256;
constexpr int kMaxThr = 2048;
constexpr int kMaxRanks = 8;
constexpr unsigned kFull = alp::kFullMask;

// K15's binning.  Thresholds into shared th[E], the block's histogram
// hist[E + 1] zeroed; the caller syncs before use.
template <typename U>
__device__ __forceinline__ void load_bins(U* th, unsigned* hist,
                                          const U* __restrict__ thr, int E) {
  for (int j = threadIdx.x; j < E; j += blockDim.x) th[j] = thr[j];
  for (int j = threadIdx.x; j <= E; j += blockDim.x) hist[j] = 0;
}

// Count one key (none when `real` is false: the pad) at its bin
// #{th < key}.  Every lane of the warp calls it together.
template <typename U>
__device__ __forceinline__ void bin_key(bool real, U key, const U* th, int E,
                                        unsigned* hist) {
  int p = -1;                                // -1: pad, counted nowhere
  if (real) {
    int lo = 0, hi = E;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (th[mid] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
    p = lo;
  }
  const unsigned peers = __match_any_sync(kFull, p);
  if (p >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[p], static_cast<unsigned>(__popc(peers)));
}

// The block's nonzero bins into the global int64 bins; after a barrier
// (K15 and K17).
__device__ __forceinline__ void flush_bins(const unsigned* hist, int E,
                                           unsigned long long* bins) {
  for (int j = threadIdx.x; j <= E; j += blockDim.x)
    if (hist[j]) atomicAdd(&bins[j], static_cast<unsigned long long>(hist[j]));
}

// K15: prefix-count bins of the keys of rows 0..n-1 (vector rows[i]).
template <class V>
__global__ void __launch_bounds__(kThreads)
key_counts_kernel(V src, const long long* __restrict__ rows, long long n,
                  long long n_values, const typename V::U* __restrict__ thr,
                  int E, unsigned long long* __restrict__ bins) {
  using U = typename V::U;
  __shared__ typename V::Shared sh;
  __shared__ U vals[kVector];
  __shared__ U th[kMaxThr];
  __shared__ unsigned hist[kMaxThr + 1];
  load_bins(th, hist, thr, E);
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const long long vec = rows[i];
    src.decode(sh, vals, i, vec);            // ends in a barrier
    const long long valid = n_values - vec * kVector;
    for (int k = threadIdx.x; k < kVector; k += kThreads)
      bin_key(k < valid, order_key(vals[k]), th, E, hist);
    __syncthreads();                         // vals is read
  }
  __syncthreads();
  flush_bins(hist, E, bins);
}

// K16: (least key, largest key) of each vector into out[rows[i]].
template <class V>
__global__ void __launch_bounds__(kThreads)
key_extremes_kernel(V src, const long long* __restrict__ rows, long long n,
                    long long n_values, typename V::U* __restrict__ out) {
  using U = typename V::U;
  constexpr int kWarps = kThreads / 32;
  __shared__ typename V::Shared sh;
  __shared__ U vals[kVector];
  __shared__ U wlo[kWarps], whi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const long long vec = rows[i];
    src.decode(sh, vals, i, vec);
    const long long valid = n_values - vec * kVector;
    U lo = static_cast<U>(~U(0)), hi = 0;
    for (int k = threadIdx.x; k < kVector; k += kThreads) {
      if (k < valid) {
        const U key = order_key(vals[k]);
        lo = umin(lo, key);
        hi = umax(hi, key);
      }
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      wlo[warp] = lo;
      whi[warp] = hi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        lo = umin(lo, wlo[w]);
        hi = umax(hi, whi[w]);
      }
      out[vec * 2] = lo;
      out[vec * 2 + 1] = hi;
    }
    __syncthreads();                         // vals and the rows are read
  }
}

// K17's search tree: the first min(E, kTree) thresholds in Eytzinger
// (breadth-first) order at nodes 1 .. 2^L - 1 of tree[], padded with all
// ones (never below a key), so every lane of a warp reads the same node at
// the root and one of 2^d nodes at depth d.  L levels of
// at = 2 at + (tree[at] < key) leave #{thresholds < key} = at - 2^L; at
// E = 2048 one compare with the last threshold adds the 2048th.  A thread
// walks its keys through the levels in lockstep: independent chains of
// shared loads.
constexpr int kTree = kMaxThr - 1;
constexpr int kPer = kVector / kThreads;     // values of a vector a thread
constexpr int kWarps = kThreads / 32;
constexpr int kCuts = 32;                    // bracket cut points, padded

// K17's dynamic shared memory: the tree at 0, then these byte offsets and
// the marks and staging buffers.
struct RankLayout : alp::StageLayout {
  int levels;                                // L
  unsigned hist, qbin, xval;
};

inline RankLayout rank_layout(int E, unsigned key_bytes, int staged) {
  RankLayout l{};
  const int tree = E < kTree ? E : kTree;
  while ((1 << l.levels) - 1 < tree) ++l.levels;
  unsigned at = round16((1u << l.levels) * key_bytes);
  l.hist = at;
  at = round16(at + (E + 1) * 4u);
  l.qbin = at;
  at = round16(at + (E + 1u) * 2u);
  l.xval = at;
  at = round16(at + 2 * kVector * key_bytes);
  static_cast<alp::StageLayout&>(l) = stage_layout(at, staged);
  return l;
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

// #{cuts < key}: the key's interval of the bracket cut points ct[kCuts]
// (ascending, padded with all ones), five broadcast-friendly steps.
template <typename U>
__device__ __forceinline__ int cut_interval(const U* ct, U key) {
  int q = 0;
#pragma unroll
  for (int step = kCuts / 2; step; step >>= 1)
    q += ct[q + step - 1] < key ? step : 0;
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

// A row's exceptions a thread holds (slots k[], -1 for none, and
// payloads p[]): their slots into the row's mark set and their payloads
// into the row's xval[1024], where the slots' owners patch them in.
template <int N, typename U>
__device__ __forceinline__ void store_exceptions(unsigned* set, U* xval,
                                                 const int (&k)[N],
                                                 const U (&p)[N]) {
  mark_slots(set, k);
#pragma unroll
  for (int m = 0; m < N; ++m)
    if (k[m] >= 0) xval[k[m]] = p[m];
}

// The block's shared tables of K17
template <typename U>
struct RankTables {
  Tree<U> tree;
  unsigned* hist;
  const uint16_t* qbin;                      // bin -> first interval, cuts
  const U* ct;
  const uint8_t* cmask;                      // cut interval -> brackets
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
  U* xval = reinterpret_cast<U*>(dyn + lay.xval);
  unsigned* marks = reinterpret_cast<unsigned*>(dyn + lay.marks);
  __shared__ U blo[kMaxRanks], bhi[kMaxRanks];
  __shared__ U wlo[kWarps][kMaxRanks], whi[kWarps][kMaxRanks];
  __shared__ U ct[kCuts];
  __shared__ uint8_t cmask[kCuts + 1];
  __shared__ int first[kMaxRanks];           // the first bracket equal to r
  __shared__ int n_cuts;
  __shared__ U ulo, uhi;
  const int tid = threadIdx.x, warp = tid >> 5;
  const U top = static_cast<U>(~U(0));
  unsigned char* const buf0 = dyn + lay.buf[0];
  unsigned char* const buf1 = dyn + lay.buf[1];
  long long i = blockIdx.x;
  if (i < n) src.stage_async(buf0, i);
  commit_async();
  // the tree, the bins, the brackets, the slots and the exception marks,
  // while the first row's words arrive
  const Tree<U> tr{tree, lay.levels, E > kTree, thr[E - 1]};
  tr.build(tree, thr, E);
  for (int j = tid; j <= E; j += kThreads) hist[j] = 0;
  for (int j = tid; j < kWarps * kMaxRanks; j += kThreads) {
    wlo[j / kMaxRanks][j % kMaxRanks] = top;
    whi[j / kMaxRanks][j % kMaxRanks] = 0;
  }
  for (int j = tid; j < kMarks * 32; j += kThreads) marks[j] = 0;
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
  // key, ascending and distinct, padded with all ones; every interval
  // between two of them lies wholly inside or outside each bracket
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
    for (int a = 1; a < nc; ++a)             // insertion sort, <= 16 cuts
      for (int b = a; b > 0 && ct[b] < ct[b - 1]; --b) {
        const U x = ct[b];
        ct[b] = ct[b - 1];
        ct[b - 1] = x;
      }
    int d = 0;
    for (int a = 0; a < nc; ++a)
      if (d == 0 || ct[a] != ct[d - 1]) ct[d++] = ct[a];
    for (int a = d; a < kCuts; ++a) ct[a] = top;
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
    cmask[tid] = static_cast<uint8_t>(m);
  }
  // bin p holds the keys in [lower, upper] = (thr[p - 1], thr[p]]: its
  // first cut interval and the number of cuts that split it (low and high
  // byte); a later pass's bins between two brackets hold two cuts
  for (int p = tid; p <= E; p += kThreads) {
    const U lower = p > 0 ? static_cast<U>(thr[p - 1] + (thr[p - 1] < top))
                          : U(0);
    const U upper = p < E ? thr[p] : top;
    const int ql = cut_interval(ct, lower), qu = cut_interval(ct, upper);
    qbin[p] = static_cast<uint16_t>(ql | (lower <= upper ? (qu - ql) << 8
                                                         : 0));
  }
  const RankTables<U> tab{tr, hist, qbin, ct, cmask, ulo, uhi, wlo[warp],
                          whi[warp]};
  // the rows are loaded ahead (vector.cuh's RowAhead); row i's exception
  // slots are marked in mark set it % kMarks during the row before, and a
  // set is cleared two rows after its row
  RowAhead<V, kPer> ra(src, rows, n, i);
  store_exceptions(marks, xval, ra.xk, ra.xp);
  for (int it = 0; i < n; i += gridDim.x, ++it) {
    const long long nxt = i + gridDim.x;
    ra.ahead();
    wait_async();
    __syncthreads();                         // row i staged and marked
    const unsigned char* buf = it & 1 ? buf1 : buf0;
    if (nxt < n) src.stage_async(it & 1 ? buf0 : buf1, nxt);
    commit_async();
    if (tid < 32) marks[32 * ((it + 2) % kMarks) + tid] = 0;
    const unsigned* mk = marks + 32 * (it % kMarks);
    const U* xv = xval + (it & 1) * kVector;
    const long long valid = n_values - ra.vec * kVector;
    U key[kPer];
    bool real[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = tid + j * kThreads;
      real[j] = k < valid;
      U b = src.value(buf, ra.rw, k);
      if ((mk[k >> 5] >> (k & 31)) & 1u) b = src.patch(buf, ra.rw, xv[k], k);
      key[j] = order_key(b);
    }
    rank_keys(key, real, tab);
    store_exceptions(marks + 32 * ((it + 1) % kMarks),
                     xval + ((it + 1) & 1) * kVector, ra.xkn, ra.xpn);
    ra.next();
  }
  __syncthreads();
  flush_bins(hist, E, bins);
  // thread r merges the warps' slots of bracket r (the first of its
  // equals)
  if (tid < R) {
    U l = top, h = 0;
    for (int w = 0; w < kWarps; ++w) {
      l = umin(l, wlo[w][first[tid]]);
      h = umax(h, whi[w][first[tid]]);
    }
    if (l <= h) merge_key(mm + 2 * tid, l, h);  // else: none in the bracket
  }
}

// Thresholds, bins and out are optional per kernel: E < 0 launches K16.
template <class V>
int launch(const V& src, const void* rows, long long n, long long n_values,
           const void* thr, int E, void* bins, void* out, int dev,
           void* stream) {
  using U = typename V::U;
  if (n < 0 || n_values < 0 || E > kMaxThr || E == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  const auto* r = static_cast<const long long*>(rows);
  const auto s = static_cast<cudaStream_t>(stream);
  if (E > 0) {
    const cudaError_t err =
        grid_for(key_counts_kernel<V>, n, dev, kThreads, 0, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks)
      key_counts_kernel<V><<<blocks, kThreads, 0, s>>>(
          src, r, n, n_values, static_cast<const U*>(thr), E,
          static_cast<unsigned long long*>(bins));
  } else {
    const cudaError_t err =
        grid_for(key_extremes_kernel<V>, n, dev, kThreads, 0, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks)
      key_extremes_kernel<V><<<blocks, kThreads, 0, s>>>(
          src, r, n, n_values, static_cast<U*>(out));
  }
  return static_cast<int>(cudaGetLastError());
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
  const RankLayout lay = rank_layout(E, sizeof(U), src.staged_bytes());
  cudaError_t err = cudaFuncSetAttribute(
      rank_pass_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = grid_for(rank_pass_kernel<V>, n, dev, kThreads, lay.bytes, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    rank_pass_kernel<V><<<blocks, kThreads, lay.bytes,
                          static_cast<cudaStream_t>(stream)>>>(
        src, static_cast<const long long*>(rows), n, n_values,
        static_cast<const U*>(thr), E, static_cast<const U*>(br), R, lay,
        static_cast<unsigned long long*>(bins), static_cast<U*>(mm));
  return static_cast<int>(cudaGetLastError());
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
// each bracket of br (keys, [R, 2]: lo, hi), 1 <= R <= 8.  Every entry
// returns cudaGetLastError() (or the error of its device query).

extern "C" int alp_key_counts_alp_f64(ALP_ARGS, const void* thr, int E,
                                      void* bins, int dev, void* stream) {
  if (bad_alp(bw, 64) || E < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ALP_ROUTE(double), rows, n, n_values, thr, E, bins, nullptr,
                dev, stream);
}

extern "C" int alp_key_counts_alp_f32(ALP_ARGS, const void* thr, int E,
                                      void* bins, int dev, void* stream) {
  if (bad_alp(bw, 32) || E < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ALP_ROUTE(float), rows, n, n_values, thr, E, bins, nullptr,
                dev, stream);
}

extern "C" int alp_key_counts_rd_f64(RD_ARGS, const void* thr, int E,
                                     void* bins, int dev, void* stream) {
  if (bad_rd(rbw, lbw, 64) || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(RD_ROUTE(uint64_t, 64), rows, n, n_values, thr, E, bins,
                nullptr, dev, stream);
}

extern "C" int alp_key_counts_rd_f32(RD_ARGS, const void* thr, int E,
                                     void* bins, int dev, void* stream) {
  if (bad_rd(rbw, lbw, 32) || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(RD_ROUTE(uint32_t, 32), rows, n, n_values, thr, E, bins,
                nullptr, dev, stream);
}

extern "C" int alp_key_extremes_alp_f64(ALP_ARGS, void* out, int dev,
                                        void* stream) {
  if (bad_alp(bw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ALP_ROUTE(double), rows, n, n_values, nullptr, -1, nullptr,
                out, dev, stream);
}

extern "C" int alp_key_extremes_alp_f32(ALP_ARGS, void* out, int dev,
                                        void* stream) {
  if (bad_alp(bw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(ALP_ROUTE(float), rows, n, n_values, nullptr, -1, nullptr,
                out, dev, stream);
}

extern "C" int alp_key_extremes_rd_f64(RD_ARGS, void* out, int dev,
                                       void* stream) {
  if (bad_rd(rbw, lbw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(RD_ROUTE(uint64_t, 64), rows, n, n_values, nullptr, -1,
                nullptr, out, dev, stream);
}

extern "C" int alp_key_extremes_rd_f32(RD_ARGS, void* out, int dev,
                                       void* stream) {
  if (bad_rd(rbw, lbw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(RD_ROUTE(uint32_t, 32), rows, n, n_values, nullptr, -1,
                nullptr, out, dev, stream);
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
