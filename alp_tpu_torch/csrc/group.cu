// Hand-written Hopper (sm_90a) grouped kernels of alp_tpu_torch: GROUP-BY
// and the windowed aggregates over a compressed column.
//
//   K18 vector_sum_extremes  replaces sum_extremes_planes_f64
//                            (alp_tpu/kernels/falp.py:2046): for each
//                            vector, its exact-SUM totals and its least and
//                            largest total-order key, fused with the decode.
//   K19 group_reduce         no TPU site: the counterpart of the XLA grouped
//                            passes of alp_tpu/engine.py (the one-hot MXU
//                            pass _mxu_scan and the segment_sum chunks
//                            _groupby_chunk_f64/_f32).  The exact-SUM totals,
//                            the row count and the least and largest key of
//                            every group, fused with the decode.
//
// Both are one template over the four routes of vector.cuh (ALP f64, ALP
// f32, ALP_RD f64, ALP_RD f32), so eight C entries.  Each decodes the
// vectors of its bucket with their true exception bits (vector.cuh: K18
// into shared memory, K19 into registers), skips the pad of a partial
// last vector and adds each value's signed 32-bit digits in digits.cuh's
// window layout: W windows over the whole exponent range (W = 66 for f64,
// 9 for f32), then the counts of NaN, +Inf and -Inf.  Integer sums are
// exact in any order, so both equal their plain versions exactly
// (tolerance 0).
//
// K18.  What site 33 computes per lane column of 8 vectors (16-bit digit
// halves in i32 over a static 4-window envelope, an out-of-envelope count,
// biased i32 key words), reduced per vector by the XLA code after it
// (alp_tpu/engine.py:2573-2601), is what K18 writes per vector: the int64
// row [W + 3] of vector rows[i] into sums[rows[i]] and its (least, largest)
// key into keys[rows[i]].  Every value lands in its window, so there is no
// envelope and no out-of-envelope row.  One block of 256 threads a vector
// (a grid stride over the bucket): digits.cuh's Acc sums the block's 1024
// values into a shared row, a warp and a block reduction take the keys'
// extremes, and the block stores the row and the pair: no global atomics.
//
// K19.  keys[i * 1024 + k] is the group id of value k of row i; an id
// outside [0, G) is not counted (the engine checks the keys first).  The
// output is out[G, W + 4] (the windows, the three special counts and the
// row count, int64) and ext[G, 2] (the least and largest key; the caller
// starts each pair at (all ones, 0), so a group that no value reaches
// keeps it).  The first design merged each warp's equal (group, window,
// sign) with __match_any_sync, then the group alone with a second match,
// and summed with 2P + 4 warp reductions a value; random keys make runs of
// 1-2 lanes, so nearly every lane then issued ~6 int64 atomics, in a
// 16-row shared table at G = 16 (where Hopper has no native 64-bit shared
// add: each is a compare-and-swap loop) or in device memory above the
// shared budget.  The present design:
//  - values in registers: vector.cuh's register decode, the next row
//    staged with cp.async and each row's metadata loaded a row ahead, the
//    exceptions marked, skipped by their owners and added from their true
//    bits by the threads that read them (as K17);
//  - G within the shared budget (G * SharedGroups::group_bytes() <=
//    kSharedAcc = 200 KB: f64 363 groups, f32 2048; it was 355 and 1828):
//    each block keeps int32 counters, the 16-bit halves of each window's
//    digit sum, and a lane adds its value with native 32-bit shared
//    atomics: two a nonzero digit (P = 3 digits for f64, 2 for f32), one
//    for the row count, and a key atomic only where the key moves the
//    group's pair as read (keys only narrow: a stale read never skips
//    one), so no match, no reduction and no compare-and-swap loop on the
//    way of a value.  A half moves by less than 2^16 a value, so the
//    block adds its halves into out every kFlushRows = 31 rows and at the
//    end.  A warp whose 32 values share one group (ordered keys, G = 1)
//    sums them first with __reduce_add_sync over its least windows, as K18
//    does, and adds each window once;
//  - G above it: the warps add their runs (lanes next to each other with
//    the same group) straight into device memory.  A run of two lanes or
//    more sums its digits with __reduce_add_sync of signed 16-bit halves,
//    its key extremes with __reduce_min/max and its counts with ballots,
//    and its first lane adds one atomic a nonzero window and one a count;
//    a run of one lane (random keys at large G) adds its own digits with no
//    reduction.  A key atomic goes out only where the run's extremes move
//    past the group's pair as read before.  Keys in order give runs of 32;
//    random keys give runs of one, and then this path's floor is its
//    atomics a value: one a nonzero digit window (at most P) and one count.
// What still keeps it from its bound: on the shared path the 2P + 1
// atomics a value, which contend on the same few rows at small G; on the
// device path its device-memory atomics.
// A group of 2^31 values or more could overflow an int64 window: one K19
// call sums fewer than 2^31 values (the wrappers check), and the engine
// sums longer columns in runs; K18's rows hold one vector each and take
// any number of vectors.
//
// K23 key_extremes_bits_f64 replaces key_extremes_planes_f64
// (alp_tpu/kernels/falp.py:1998), the key half of site 33 over decoded
// bits: each vector's least and largest total-order key (order_key, -0.0
// folded onto +0.0, as _key_words_f64 does), every one of its 1024 values
// read (the TPU kernel has no pad either), as uint64 [n, 2].  Site 32's
// biased i32 words per lane column of 8 vectors are a layout of the TPU;
// what the grouped aggregates read is the vector's pair.  It is bound by
// bytes (8 read a value, 16 written a vector): one block of 256 threads a
// vector, 4 coalesced loads a thread, a warp and a block reduction.
//
// Bound.  K18 and K19 read only the packed words, the metadata, the row
// ids and the exceptions of their vectors (a few bits a value), K19 also 4
// bytes of group id a value, and write a few hundred bytes a vector (K18)
// or group (K19).  The work is the exact sum's (chip_smoke.py's SUM_OPS)
// plus the decode and the key (KEY_OPS) and two compares a value, at the
// INT32 issue rate: both are bound by operations, K19 at 256 MiB by the
// bytes of its group ids as well.  The atomics, reductions and flushes
// above are the design's cost, not the function's.

#include <cstdint>
#include <cuda_runtime.h>

#include "digits.cuh"
#include "vector.cuh"

namespace {

using alp::Acc;
using alp::kAccR;
using alp::atomic_add;
using alp::bad_alp;
using alp::bad_rd;
using alp::commit_async;
using alp::Fixed;
using alp::grid_for;
using alp::kMarks;
using alp::kVector;
using alp::mark_slots;
using alp::order_key;
using alp::peer_extremes;
using alp::round16;
using alp::RowAhead;
using alp::stage_layout;
using alp::umax;
using alp::umin;
using alp::wait_async;
using alp::warp_max;
using alp::warp_min;
using alp::zero_row;
constexpr int kThreads = alp::kAccThreads;
constexpr int kPer = alp::kAccPer;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = alp::kFullMask;
// K19's shared accumulators: G * SharedGroups::group_bytes() bytes at
// most (564 a group for f64: 363 groups; 100 for f32: 2048), so that with
// the staging buffers (at most 2 x 10,256 bytes, f64 ALP_RD at bit widths
// 64 and 16) and the marks a block fits in the 232,448 bytes of shared
// memory a block can take
constexpr size_t kSharedAcc = 200 * 1024;
constexpr int kFlushRows = 31;              // 31 * 1024 * 65535 < 2^31
constexpr int kMaxGroups = 1 << 24;         // a group id fills 24 bits

// K18: the exact-SUM row and the key extremes of each vector.
template <class V>
__global__ void __launch_bounds__(kThreads)
vector_sums_kernel(V src, const long long* __restrict__ rows, long long n,
                   long long n_values, long long* __restrict__ sums,
                   typename V::U* __restrict__ keys) {
  using U = typename V::U;
  constexpr int kRow = Fixed<U>::W + 3;
  __shared__ typename V::Shared sh;
  __shared__ U vals[kVector];
  __shared__ long long row[kRow];
  __shared__ U wlo[kWarps], whi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  zero_row<U>(row);
  for (long long i = blockIdx.x; i < n; i += gridDim.x) {
    const long long vec = rows[i];
    src.decode(sh, vals, i, vec);            // ends in a barrier
    const long long valid = n_values - vec * kVector;
    U b[kPer];
    bool ok[kPer];
    U lo = static_cast<U>(~U(0)), hi = 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int k = threadIdx.x + r * kThreads;
      b[r] = vals[k];
      ok[r] = k < valid;
      if (ok[r]) {
        const U key = order_key(b[r]);
        lo = umin(lo, key);
        hi = umax(hi, key);
      }
    }
    Acc<U> acc(row);
    acc.add(b, ok);
    acc.settle();
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      wlo[warp] = lo;
      whi[warp] = hi;
    }
    __syncthreads();                         // the row and the keys are in
    for (int j = threadIdx.x; j < kRow; j += kThreads) {
      sums[vec * kRow + j] = row[j];
      row[j] = 0;
    }
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        lo = umin(lo, wlo[w]);
        hi = umax(hi, whi[w]);
      }
      keys[vec * 2] = lo;
      keys[vec * 2 + 1] = hi;
    }
    __syncthreads();                         // vals, row and wlo/whi are read
  }
}

// atomicMin / atomicMax of an unsigned key of either width, shared or
// global
__device__ __forceinline__ void key_min(uint64_t* at, uint64_t v) {
  atomicMin(reinterpret_cast<unsigned long long*>(at),
            static_cast<unsigned long long>(v));
}
__device__ __forceinline__ void key_min(uint32_t* at, uint32_t v) {
  atomicMin(reinterpret_cast<unsigned*>(at), static_cast<unsigned>(v));
}
__device__ __forceinline__ void key_max(uint64_t* at, uint64_t v) {
  atomicMax(reinterpret_cast<unsigned long long*>(at),
            static_cast<unsigned long long>(v));
}
__device__ __forceinline__ void key_max(uint32_t* at, uint32_t v) {
  atomicMax(reinterpret_cast<unsigned*>(at), static_cast<unsigned>(v));
}

// A key read through L2, not L1 (the pair a warp merges keys into)
__device__ __forceinline__ uint64_t load_cg(const uint64_t* at) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(at));
}
__device__ __forceinline__ uint32_t load_cg(const uint32_t* at) {
  return __ldcg(reinterpret_cast<const unsigned*>(at));
}

// Keys only narrow: lo down, hi up.  Where the pair (seen_lo, seen_hi),
// read from kx earlier, already brackets [lo, hi] no atomic is needed; a
// stale read is wider than the pair, so it never skips a needed one.
template <typename U>
__device__ __forceinline__ void settle_key(U* kx, U lo, U hi, U seen_lo,
                                           U seen_hi) {
  if (lo < seen_lo) key_min(kx, lo);
  if (hi > seen_hi) key_max(kx + 1, hi);
}

// The runs of one value a lane: lanes next to each other with the same
// group (real lanes only).  A run of two lanes or more sums its digits in
// kSlots windows from its least window jb (a lane's digit p lands in slot
// j - jb + p; a lane two windows or more above jb adds its own digits), as
// signed 16-bit halves with __reduce_add_sync over the run's mask, takes
// its key extremes with __reduce_min/max_sync and its counts with ballots;
// the run's first lane then adds one atomic a nonzero window, one for the
// row count (and one a special class present) and merges the keys where
// they move past the pair read earlier (seen_lo, seen_hi).  A run of one
// lane adds its own values without reductions: __reduce_*_sync is issued
// once per distinct mask of the warp.  Every lane of the warp calls it
// together.
template <typename U>
__device__ __forceinline__ void add_run(bool real, int g, U b, long long* acc,
                                        U* kx, U seen_lo, U seen_hi) {
  using Fx = Fixed<U>;
  constexpr int kCols = Fx::W + 4;
  constexpr int kSlots = kAccR + Fx::P - 1;
  const int lane = threadIdx.x & 31;
  const int gg = real ? g : -1;
  const int up = __shfl_up_sync(kFull, gg, 1);
  const unsigned starts = __ballot_sync(kFull, lane == 0 || gg != up);
  const unsigned le = lane == 31 ? kFull : (2u << lane) - 1u;
  const unsigned above = starts & ~le;
  const int first = 31 - __clz(starts & le);
  unsigned peers = (above ? (1u << (__ffs(above) - 1)) - 1u : kFull) &
                   ~((1u << first) - 1u);
  if (!real) peers = 1u << lane;
  const bool multi = __popc(peers) > 1;      // the same for the whole run
  const bool lead = real && lane == first;
  const Fx x(b);
  const bool fin = real && x.j >= 0;
  long long* row = acc + static_cast<long long>(real ? g : 0) * kCols;
  unsigned jb = fin ? static_cast<unsigned>(x.j) : 0xffffffffu;
  if (multi) jb = __reduce_min_sync(peers, jb);
  const int rel = fin ? x.j - static_cast<int>(jb) : 0;
  if (fin && (!multi || rel >= kAccR)) {     // a lane alone, or far above
#pragma unroll
    for (int p = 0; p < Fx::P; ++p)
      if (x.d[p]) {
        const long long d = x.d[p];
        atomic_add(&row[x.j + p], x.neg ? -d : d);
      }
  }
  if (multi) {
    const bool near = fin && rel < kAccR;
#pragma unroll
    for (int w = 0; w < kSlots; ++w) {
      uint32_t d = 0;
#pragma unroll
      for (int p = 0; p < Fx::P; ++p)
        if (w - p >= 0 && w - p < kAccR && near && rel == w - p) d = x.d[p];
      const int lo16 = static_cast<int>(d & 0xffffu);
      const int hi16 = static_cast<int>(d >> 16);
      const int slo = __reduce_add_sync(peers, x.neg ? -lo16 : lo16);
      const int shi = __reduce_add_sync(peers, x.neg ? -hi16 : hi16);
      const long long s = static_cast<long long>(slo) +
                          static_cast<long long>(shi) * 65536;
      if (lead && s) atomic_add(&row[jb + w], s);
    }
  }
  if (__any_sync(kFull, real && x.cls)) {
#pragma unroll
    for (int c = 1; c <= 3; ++c) {
      const unsigned bc = __ballot_sync(kFull, real && x.cls == c) & peers;
      if (lead && bc) atomic_add(&row[Fx::W + c - 1], __popc(bc));
    }
  }
  U lo = order_key(b), hi = lo;
  if (multi) peer_extremes(peers, lo, lo, hi);
  if (lead) {
    atomic_add(&row[Fx::W + 3], __popc(peers));
    settle_key(kx + 2 * static_cast<long long>(g), lo, hi, seen_lo, seen_hi);
  }
}

// K19's shared accumulators of G groups.  Group g's row of int32
// counters holds the low and the high 16-bit half of each window's signed
// digit sum (columns 2 w and 2 w + 1 of kStride = 2 W + 1: odd, so that
// lanes of distinct groups hit distinct banks); its row count, its three
// special counts and its key pair lie apart.  A half moves by less than
// 2^16 a value and a vector adds at most 1024 values, so the counters stay
// exact for kFlushRows rows; then the block adds them into out and clears
// them.
template <typename U>
struct SharedGroups {
  using Fx = Fixed<U>;
  static constexpr int kStride = 2 * Fx::W + 1;
  int* half;                                 // [G, kStride]
  unsigned* count;                           // [G]
  unsigned* spec;                            // [3, G]: NaN, +Inf, -Inf
  U* kx;                                     // [G, 2]
  int G;

  static constexpr size_t group_bytes() {
    return kStride * 4 + 4 + 3 * 4 + 2 * sizeof(U);
  }

  // signed digit d of window w into the row's halves
  __device__ __forceinline__ static void add_digit(int* row, int w,
                                                   uint32_t d, bool neg) {
    const int lo = static_cast<int>(d & 0xffffu);
    const int hi = static_cast<int>(d >> 16);
    if (lo) atomicAdd(&row[2 * w], neg ? -lo : lo);
    if (hi) atomicAdd(&row[2 * w + 1], neg ? -hi : hi);
  }

  // key k into group g's pair, with an atomic only where it moves the
  // pair as read (keys only narrow: a stale read never skips one)
  __device__ __forceinline__ void add_key(int g, U lo, U hi) const {
    const volatile U* p = kx + 2 * g;
    settle_key(kx + 2 * g, lo, hi, p[0], p[1]);
  }

  // One lane's value: P digit windows as halves, its count, its class,
  // its key: native 32-bit shared atomics (a 64-bit one would be a CAS
  // loop), no match and no reduction.
  __device__ __forceinline__ void add_own(int g, U b) const {
    const Fx x(b);
    int* row = half + g * kStride;
    if (x.j >= 0) {
#pragma unroll
      for (int p = 0; p < Fx::P; ++p)
        if (x.d[p]) add_digit(row, x.j + p, x.d[p], x.neg);
    }
    if (x.cls) atomicAdd(&spec[(x.cls - 1) * G + g], 1u);
    atomicAdd(&count[g], 1u);
    const U k = order_key(b);
    add_key(g, k, k);
  }

  // The whole warp's values, all of group g (ordered keys, G = 1): the
  // digits as halves summed over the warp with __reduce_add_sync in
  // kAccR + P - 1 windows from the warp's least window (a lane two windows
  // or more above adds its own), the counts with ballots and the keys with
  // __reduce_min/max; lane 0 adds them.  Every lane calls it together.
  __device__ __forceinline__ void add_warp(int g, U b) const {
    constexpr int kSlots = kAccR + Fx::P - 1;
    const bool lead = (threadIdx.x & 31) == 0;
    const Fx x(b);
    int* row = half + g * kStride;
    const bool fin = x.j >= 0;
    const unsigned jb = __reduce_min_sync(
        kFull, fin ? static_cast<unsigned>(x.j) : 0xffffffffu);
    const int rel = fin ? x.j - static_cast<int>(jb) : 0;
    if (fin && rel >= kAccR) {
#pragma unroll
      for (int p = 0; p < Fx::P; ++p)
        if (x.d[p]) add_digit(row, x.j + p, x.d[p], x.neg);
    }
    if (jb != 0xffffffffu) {                 // warp-uniform
      const bool near = fin && rel < kAccR;
#pragma unroll
      for (int w = 0; w < kSlots; ++w) {
        uint32_t d = 0;
#pragma unroll
        for (int p = 0; p < Fx::P; ++p)
          if (w - p >= 0 && w - p < kAccR && near && rel == w - p)
            d = x.d[p];
        const int lo = static_cast<int>(d & 0xffffu);
        const int hi = static_cast<int>(d >> 16);
        const int slo = __reduce_add_sync(kFull, x.neg ? -lo : lo);
        const int shi = __reduce_add_sync(kFull, x.neg ? -hi : hi);
        if (lead && slo) atomicAdd(&row[2 * (jb + w)], slo);
        if (lead && shi) atomicAdd(&row[2 * (jb + w) + 1], shi);
      }
    }
    if (__any_sync(kFull, x.cls != 0)) {
#pragma unroll
      for (int c = 1; c <= 3; ++c) {
        const unsigned bc = __ballot_sync(kFull, x.cls == c);
        if (lead && bc) atomicAdd(&spec[(c - 1) * G + g], __popc(bc));
      }
    }
    U lo = order_key(b), hi = lo;
    peer_extremes(kFull, lo, lo, hi);
    if (lead) {
      atomicAdd(&count[g], 32u);
      add_key(g, lo, hi);
    }
  }

  // A value a lane (none where `real` is false); every lane of the warp
  // calls it together.
  __device__ __forceinline__ void add(bool real, int g, U b) const {
    const int g0 = __shfl_sync(kFull, g, 0);
    if (__all_sync(kFull, real && g == g0))
      add_warp(g0, b);
    else if (real)
      add_own(g, b);
  }

  // The window halves into out [G, W + 4], cleared; after a barrier.
  __device__ __forceinline__ void flush(long long* out) const {
    for (int at = threadIdx.x; at < G * Fx::W; at += blockDim.x) {
      const int g = at / Fx::W, w = at - g * Fx::W;
      int* c = half + g * kStride + 2 * w;
      const long long v = static_cast<long long>(c[0]) +
                          static_cast<long long>(c[1]) * 65536;
      if (v) atomic_add(&out[static_cast<long long>(g) * (Fx::W + 4) + w], v);
      c[0] = 0;
      c[1] = 0;
    }
  }

  // The counts and keys into out and ext; after a barrier.
  __device__ __forceinline__ void finish(long long* out, U* ext) const {
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      long long* o = out + static_cast<long long>(g) * (Fx::W + 4);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (spec[c * G + g]) atomic_add(&o[Fx::W + c], spec[c * G + g]);
      if (count[g]) atomic_add(&o[Fx::W + 3], count[g]);
      if (kx[2 * g] <= kx[2 * g + 1])
        settle_key(ext + 2 * g, kx[2 * g], kx[2 * g + 1],
                   load_cg(ext + 2 * g), load_cg(ext + 2 * g + 1));
    }
  }
};

// K19's dynamic shared memory (byte offsets).  In shared memory: the
// groups' halves at 0, counts, special counts and keys; either way the
// exception marks and the two staging buffers.
struct GroupLayout : alp::StageLayout {
  unsigned count, spec, kx;
};

template <typename U>
GroupLayout group_layout(bool in_shared, int G, int staged) {
  GroupLayout l{};
  unsigned at = 0;
  if (in_shared) {
    const unsigned g = static_cast<unsigned>(G);
    l.count = at = round16(g * SharedGroups<U>::kStride * 4u);
    l.spec = at = round16(at + g * 4u);
    l.kx = at = round16(at + 3u * g * 4u);
    at = round16(at + 2u * g * sizeof(U));
  }
  static_cast<alp::StageLayout&>(l) = stage_layout(at, staged);
  return l;
}

// K19: the groups' totals, counts and key extremes of rows 0..n-1.  With
// kShared, each block adds its values into its shared counters, adds the
// window halves into out every kFlushRows rows and everything into out /
// ext at the end; otherwise each warp adds its values' runs straight into
// out / ext.
template <class V, bool kShared>
__global__ void __launch_bounds__(kThreads)
group_reduce_kernel(V src, const long long* __restrict__ rows, long long n,
                    long long n_values, const int* __restrict__ gkeys, int G,
                    GroupLayout lay, long long* __restrict__ out,
                    typename V::U* __restrict__ ext) {
  using U = typename V::U;
  extern __shared__ __align__(16) unsigned char dyn[];
  const SharedGroups<U> sgr{reinterpret_cast<int*>(dyn),
                            reinterpret_cast<unsigned*>(dyn + lay.count),
                            reinterpret_cast<unsigned*>(dyn + lay.spec),
                            reinterpret_cast<U*>(dyn + lay.kx), G};
  unsigned* marks = reinterpret_cast<unsigned*>(dyn + lay.marks);
  const int tid = threadIdx.x;
  long long i = blockIdx.x;
  unsigned char* const buf0 = dyn + lay.buf[0];
  unsigned char* const buf1 = dyn + lay.buf[1];
  if (i < n) src.stage_async(buf0, i);
  commit_async();
  if (kShared) {
    for (int j = tid; j < G * SharedGroups<U>::kStride; j += kThreads)
      sgr.half[j] = 0;
    for (int g = tid; g < G; g += kThreads) {
      sgr.count[g] = 0;
      sgr.spec[g] = sgr.spec[G + g] = sgr.spec[2 * G + g] = 0;
      sgr.kx[2 * g] = static_cast<U>(~U(0));
      sgr.kx[2 * g + 1] = 0;
    }
  }
  for (int j = tid; j < kMarks * 32; j += kThreads) marks[j] = 0;
  __syncthreads();
  // the rows are loaded ahead and the exceptions marked as in K17
  RowAhead<V, kPer> ra(src, rows, n, i);
  mark_slots(marks, ra.xk);
  for (int it = 0; i < n; i += gridDim.x, ++it) {
    const long long nxt = i + gridDim.x;
    ra.ahead();
    int g[kPer], xg[kPer];
    U seen[kPer][2];                         // device path: the pairs so far
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      g[j] = gkeys[i * kVector + tid + j * kThreads];
      xg[j] = ra.xk[j] >= 0 ? gkeys[i * kVector + ra.xk[j]] : -1;
      const bool in = !kShared && g[j] >= 0 && g[j] < G;
      seen[j][0] = in ? load_cg(ext + 2 * static_cast<long long>(g[j])) : 0;
      seen[j][1] = in ? load_cg(ext + 2 * static_cast<long long>(g[j]) + 1)
                      : 0;
    }
    wait_async();
    __syncthreads();                         // row i staged and marked
    const unsigned char* buf = it & 1 ? buf1 : buf0;
    if (nxt < n) src.stage_async(it & 1 ? buf0 : buf1, nxt);
    commit_async();
    if (tid < 32) marks[32 * ((it + 2) % kMarks) + tid] = 0;
    const unsigned* mk = marks + 32 * (it % kMarks);
    const long long valid = n_values - ra.vec * kVector;
    U b[kPer], xb[kPer];
    bool real[kPer], xok[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = tid + j * kThreads;
      real[j] = k < valid && g[j] >= 0 && g[j] < G &&
                !((mk[k >> 5] >> (k & 31)) & 1u);
      b[j] = src.value(buf, ra.rw, k);
      // the exceptions' true values, at most kPer a thread
      const int xk = ra.xk[j];
      xok[j] = xk >= 0 && xk < valid && xg[j] >= 0 && xg[j] < G;
      xb[j] = xok[j] ? src.patch(buf, ra.rw, ra.xp[j], xk) : U(0);
    }
    mark_slots(marks + 32 * ((it + 1) % kMarks), ra.xkn);
    if (kShared) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) sgr.add(real[j], g[j], b[j]);
#pragma unroll
      for (int m = 0; m < kPer; ++m)
        if (xok[m]) sgr.add_own(xg[m], xb[m]);
      if ((it + 1) % kFlushRows == 0) {      // block-uniform
        __syncthreads();
        sgr.flush(out);
        __syncthreads();
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        add_run(real[j], g[j], b[j], out, ext, seen[j][0], seen[j][1]);
#pragma unroll
      for (int m = 0; m < kPer; ++m)
        if (ra.e0 + m * kThreads < ra.e1) {  // block-uniform
          const long long at = 2 * static_cast<long long>(xok[m] ? xg[m] : 0);
          add_run(xok[m], xg[m], xb[m], out, ext, load_cg(ext + at),
                  load_cg(ext + at + 1));
        }
    }
    ra.next();
  }
  if (kShared) {
    __syncthreads();
    sgr.flush(out);
    sgr.finish(out, ext);
  }
}

// A call sums fewer than 2^31 values (n rows of 1024).
bool bad_size(long long n, long long n_values) {
  return n < 0 || n * kVector >= (1ll << 31) || n_values < 0;
}

template <class V>
int launch_sums(const V& src, const void* rows, long long n,
                long long n_values, void* sums, void* keys, int dev,
                void* stream) {
  using U = typename V::U;
  // each row holds one vector's totals: no call size can overflow them
  if (n < 0 || n_values < 0) return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  const cudaError_t err =
      grid_for(vector_sums_kernel<V>, n, dev, kThreads, 0, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    vector_sums_kernel<V><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        src, static_cast<const long long*>(rows), n, n_values,
        static_cast<long long*>(sums), static_cast<U*>(keys));
  return static_cast<int>(cudaGetLastError());
}

template <class V, bool kShared>
int launch_group_as(const V& src, const void* rows, long long n,
                    long long n_values, const void* gkeys, int G, void* out,
                    void* ext, int dev, void* stream) {
  using U = typename V::U;
  const GroupLayout lay = group_layout<U>(kShared, G, src.staged_bytes());
  cudaError_t err = cudaFuncSetAttribute(
      group_reduce_kernel<V, kShared>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  unsigned blocks = 0;
  if (err == cudaSuccess)
    err = grid_for(group_reduce_kernel<V, kShared>, n, dev, kThreads,
                   lay.bytes, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks)
    group_reduce_kernel<V, kShared><<<blocks, kThreads, lay.bytes,
                                      static_cast<cudaStream_t>(stream)>>>(
        src, static_cast<const long long*>(rows), n, n_values,
        static_cast<const int*>(gkeys), G, lay,
        static_cast<long long*>(out), static_cast<U*>(ext));
  return static_cast<int>(cudaGetLastError());
}

template <class V>
int launch_group(const V& src, const void* rows, long long n,
                 long long n_values, const void* gkeys, int G, void* out,
                 void* ext, int dev, void* stream) {
  using U = typename V::U;
  if (bad_size(n, n_values) || G < 1 || G > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool in_shared =
      static_cast<size_t>(G) * SharedGroups<U>::group_bytes() <= kSharedAcc;
  return in_shared ? launch_group_as<V, true>(src, rows, n, n_values, gkeys,
                                              G, out, ext, dev, stream)
                   : launch_group_as<V, false>(src, rows, n, n_values, gkeys,
                                               G, out, ext, dev, stream);
}

// K23: one block a vector, a grid stride over the vectors.
__global__ void __launch_bounds__(kThreads)
key_extremes_bits_kernel(const uint64_t* __restrict__ bits, long long n,
                         uint64_t* __restrict__ keys) {
  __shared__ uint64_t wlo[kWarps], whi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long v = blockIdx.x; v < n; v += gridDim.x) {
    uint64_t lo = ~uint64_t(0), hi = 0;
    for (int k = threadIdx.x; k < kVector; k += kThreads) {
      const uint64_t key = order_key(bits[v * kVector + k]);
      lo = umin(lo, key);
      hi = umax(hi, key);
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
      keys[v * 2] = lo;
      keys[v * 2 + 1] = hi;
    }
    __syncthreads();                         // wlo/whi are read
  }
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers on card
// `dev`, which the caller has made current.  ALP entries take K1/K2's
// bucket arguments and the plan's ALP exception CSR (exc_bits: true
// bits); RD entries K3/K4's and the RD exception CSR (exc_left: raw left
// parts).  K18 writes sums (int64 [n_vectors, W + 3]) and keys (keys,
// [n_vectors, 2]) at rows rows[i].  K19 reads gkeys (int32 [n, 1024], the
// group id of every value of row i), 1 <= G <= 2^24, and adds into out
// (int64 [G, W + 4]) and merges into ext (keys, [G, 2]).  Every entry
// returns cudaGetLastError() (or the error of its device query).

extern "C" int alp_vector_sums_alp_f64(ALP_ARGS, void* sums, void* keys,
                                       int dev, void* stream) {
  if (bad_alp(bw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sums(ALP_ROUTE(double), rows, n, n_values, sums, keys, dev,
                     stream);
}

extern "C" int alp_vector_sums_alp_f32(ALP_ARGS, void* sums, void* keys,
                                       int dev, void* stream) {
  if (bad_alp(bw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sums(ALP_ROUTE(float), rows, n, n_values, sums, keys, dev,
                     stream);
}

extern "C" int alp_vector_sums_rd_f64(RD_ARGS, void* sums, void* keys,
                                      int dev, void* stream) {
  if (bad_rd(rbw, lbw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sums(RD_ROUTE(uint64_t, 64), rows, n, n_values, sums, keys,
                     dev, stream);
}

extern "C" int alp_vector_sums_rd_f32(RD_ARGS, void* sums, void* keys,
                                      int dev, void* stream) {
  if (bad_rd(rbw, lbw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sums(RD_ROUTE(uint32_t, 32), rows, n, n_values, sums, keys,
                     dev, stream);
}

extern "C" int alp_group_reduce_alp_f64(ALP_ARGS, const void* gkeys, int G,
                                        void* out, void* ext, int dev,
                                        void* stream) {
  if (bad_alp(bw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_group(ALP_ROUTE(double), rows, n, n_values, gkeys, G, out,
                      ext, dev, stream);
}

extern "C" int alp_group_reduce_alp_f32(ALP_ARGS, const void* gkeys, int G,
                                        void* out, void* ext, int dev,
                                        void* stream) {
  if (bad_alp(bw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_group(ALP_ROUTE(float), rows, n, n_values, gkeys, G, out,
                      ext, dev, stream);
}

extern "C" int alp_group_reduce_rd_f64(RD_ARGS, const void* gkeys, int G,
                                       void* out, void* ext, int dev,
                                       void* stream) {
  if (bad_rd(rbw, lbw, 64)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_group(RD_ROUTE(uint64_t, 64), rows, n, n_values, gkeys, G,
                      out, ext, dev, stream);
}

extern "C" int alp_group_reduce_rd_f32(RD_ARGS, const void* gkeys, int G,
                                       void* out, void* ext, int dev,
                                       void* stream) {
  if (bad_rd(rbw, lbw, 32)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_group(RD_ROUTE(uint32_t, 32), rows, n, n_values, gkeys, G,
                      out, ext, dev, stream);
}

// K23.  bits: uint64 [n, 1024] decoded f64 bit patterns; keys: uint64
// [n, 2] (least, largest) unsigned keys.
extern "C" int alp_key_extremes_bits_f64(const void* bits, long long n,
                                         void* keys, int dev, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = 0;
  cudaError_t err = grid_for(key_extremes_bits_kernel, n, dev, kThreads, 0,
                             &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0)
    key_extremes_bits_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(bits), n, static_cast<uint64_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}
