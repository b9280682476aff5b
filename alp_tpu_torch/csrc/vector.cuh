// One vector of a plan bucket, decoded into shared memory with its true
// exception bits written in, and the IEEE-754 total-order key of a value.
//
// The key kernels K15-K17 (keys.cu) and the grouped kernels K18/K19
// (group.cu) read every value of a vector through one of four routes, ALP
// f64, ALP f32, ALP_RD f64 and ALP_RD f32.  Each route is a struct with
// the bucket's arguments, as K1-K4 take them, and the plan's per-vector
// exception CSR (a compressed row index: vector vec's exceptions are
// entries exc_ptr[vec] .. exc_ptr[vec + 1] of exc_index, their flat
// positions vec * 1024 + k, and of the true bits or left parts).  decode()
// stages the packed words with fastlanes.cuh's stage(), computes K1/K2's
// formula or K3/K4's glue, then overwrites the exception slots, so the
// values are the column's own bits (NaN, +-Inf and -0.0 included).  The
// pad of a partial last vector is left to the caller.  The header also
// holds what those kernels share around the routes: the key helpers, the
// grid size and the C arguments of a bucket (ALP_ARGS, RD_ARGS).
//
// Beside decode(), each route has a register-resident decode for the
// kernels that keep a thread's values in registers (K17, K19): stage_async()
// starts a cp.async copy of a row's packed words (and, for ALP_RD, its
// dictionary) into a staging buffer, so the next row's copy runs while the
// current row is read; value() unpacks value k of the staged row straight
// into a register, before the exception patch; patches() says whether the
// route's exceptions change a value (ALP_RD at rbw = S does not), slot() is
// an exception's position in its vector, payload() what the plan stores
// for it (ALP: its true bits, ALP_RD: its left part) and patch() its true
// bits from the payload and the staged row.  RowAhead (below) loads the
// rows' metadata and exceptions ahead of the row being read; the caller
// marks the exception slots and takes each exception's true bits from
// patch(), either in the thread that owns the slot (K17) or in the thread
// that loaded the exception, the owner skipping its slot (K19).
//
// The key of bits b is ~b for a negative value and b | sign otherwise,
// after -0.0 is mapped to +0.0: unsigned order on keys is the total order
// -NaN < -Inf < finite < +Inf < +NaN, with the two zeros equal
// (alp_tpu/engine.py _float_key and _key_from_limbs).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "fastlanes.cuh"

namespace alp {

template <typename U>
__device__ __forceinline__ U order_key(U b) {
  constexpr U kSign = U(1) << (sizeof(U) * 8 - 1);
  if (b == kSign) b = 0;
  return (b & kSign) ? static_cast<U>(~b) : static_cast<U>(b | kSign);
}

constexpr unsigned kFullMask = 0xffffffffu;

// unsigned min / max of any width (uint64_t is unsigned long here)
template <typename U>
__device__ __forceinline__ U umin(U a, U b) { return b < a ? b : a; }
template <typename U>
__device__ __forceinline__ U umax(U a, U b) { return a < b ? b : a; }

template <typename U>
__device__ __forceinline__ U warp_min(U v) {
  for (int o = 16; o; o >>= 1)
    v = umin(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

template <typename U>
__device__ __forceinline__ U warp_max(U v) {
  for (int o = 16; o; o >>= 1)
    v = umax(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// atomicMin / atomicMax of an unsigned key of either width
__device__ __forceinline__ void merge_key(uint64_t* mm, uint64_t lo,
                                          uint64_t hi) {
  auto* p = reinterpret_cast<unsigned long long*>(mm);
  atomicMin(p, static_cast<unsigned long long>(lo));
  atomicMax(p + 1, static_cast<unsigned long long>(hi));
}
__device__ __forceinline__ void merge_key(uint32_t* mm, uint32_t lo,
                                          uint32_t hi) {
  auto* p = reinterpret_cast<unsigned*>(mm);
  atomicMin(p, static_cast<unsigned>(lo));
  atomicMax(p + 1, static_cast<unsigned>(hi));
}

// The least and the largest key among the lanes of `peers` (each lane of
// the mask calls it with the same mask; a 64-bit key in two halves).
__device__ __forceinline__ void peer_extremes(unsigned peers, uint64_t key,
                                              uint64_t& lo, uint64_t& hi) {
  const unsigned kh = static_cast<unsigned>(key >> 32);
  const unsigned kl = static_cast<unsigned>(key);
  const unsigned mh = __reduce_min_sync(peers, kh);
  const unsigned ml = __reduce_min_sync(peers, kh == mh ? kl : 0xffffffffu);
  const unsigned xh = __reduce_max_sync(peers, kh);
  const unsigned xl = __reduce_max_sync(peers, kh == xh ? kl : 0u);
  lo = (static_cast<uint64_t>(mh) << 32) | ml;
  hi = (static_cast<uint64_t>(xh) << 32) | xl;
}
__device__ __forceinline__ void peer_extremes(unsigned peers, uint32_t key,
                                              uint32_t& lo, uint32_t& hi) {
  lo = __reduce_min_sync(peers, key);
  hi = __reduce_max_sync(peers, key);
}

// 16-byte cp.async of `bytes` (a multiple of 16) from global `src` into
// shared `dst` (16-byte aligned) by the block's threads; a source that is
// not 16-byte aligned is copied by plain 2-byte stores instead.  Either is
// visible to the block after wait_async() and a barrier.
__device__ __forceinline__ void copy_async(unsigned char* dst,
                                           const void* src, int bytes) {
  const auto* s = static_cast<const unsigned char*>(src);
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    for (int o = threadIdx.x * 16; o < bytes; o += blockDim.x * 16) {
      const auto d = static_cast<unsigned>(__cvta_generic_to_shared(dst + o));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(s + o)
                   : "memory");
    }
  } else {
    for (int o = threadIdx.x * 2; o < bytes; o += blockDim.x * 2)
      *reinterpret_cast<uint16_t*>(dst + o) =
          *reinterpret_cast<const uint16_t*>(s + o);
  }
}
__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ALP route (K1/K2's decode).  exc_bits: the exceptions' true bits.
template <typename F>
struct AlpVector {
  using U = typename Num<F>::U;
  static constexpr int S = Num<F>::S;
  struct Shared {
    U words[kVector];                        // bw <= S: at most 1024 words
  };
  const U* packed;
  int bw;
  const U* base;
  const U* fact;
  const F* frac;
  const long long* exc_ptr;
  const long long* exc_index;
  const U* exc_bits;

  // Row i of the bucket, vector `vec` of the column, into vals[1024].
  // Every thread of the block calls it; it returns after a barrier.
  __device__ __forceinline__ void decode(Shared& sh, U* vals, long long i,
                                         long long vec) const {
    stage<U, S>(sh.words, packed + i * bw * (kVector / S), bw);
    __syncthreads();
    const U b0 = base[i], f = fact[i];
    const F fr = frac[i];
    for (int k = threadIdx.x; k < kVector; k += blockDim.x) {
      const U u = bw ? unpack<U, S>(sh.words, bw, k) : U(0);
      vals[k] = Num<F>::bits(Num<F>::decode(static_cast<U>((b0 + u) * f),
                                            fr));
    }
    __syncthreads();
    const long long e1 = exc_ptr[vec + 1];
    for (long long e = exc_ptr[vec] + threadIdx.x; e < e1; e += blockDim.x)
      vals[exc_index[e] & (kVector - 1)] = exc_bits[e];
    __syncthreads();
  }

  // The register-resident decode (see the head of this file).
  struct Row {
    U b0, f;
    F fr;
  };
  __host__ __device__ int staged_bytes() const {
    return bw * (kVector / S) * static_cast<int>(sizeof(U));
  }
  __device__ __forceinline__ void stage_async(unsigned char* buf,
                                              long long i) const {
    copy_async(buf, packed + i * bw * (kVector / S), staged_bytes());
  }
  __device__ __forceinline__ Row row(long long i) const {
    return {base[i], fact[i], frac[i]};
  }
  __device__ __forceinline__ U value(const unsigned char* buf, const Row& r,
                                     int k) const {
    const U u = bw ? unpack<U, S>(reinterpret_cast<const U*>(buf), bw, k)
                   : U(0);
    return Num<F>::bits(Num<F>::decode(static_cast<U>((r.b0 + u) * r.f),
                                       r.fr));
  }
  __device__ __forceinline__ bool patches() const { return true; }
  __device__ __forceinline__ int slot(long long e) const {
    return static_cast<int>(exc_index[e] & (kVector - 1));
  }
  __device__ __forceinline__ U payload(long long e) const {
    return exc_bits[e];
  }
  __device__ __forceinline__ U patch(const unsigned char*, const Row&, U pay,
                                     int) const {
    return pay;
  }
};

// ALP_RD route (K3/K4's glue).  exc_left: the exceptions' raw left parts,
// placed above the right bits already decoded (DecodePlan.patch_rd).
template <typename U_, int S_>
struct RdVector {
  using U = U_;
  static constexpr int S = S_;
  struct Shared {
    U rwords[kVector];
    uint16_t lwords[kVector];                // lbw <= 16: at most 1024
    U entries[8];
  };
  const U* right;
  int rbw;
  const uint16_t* left;
  int lbw;
  const uint16_t* dict;
  const int* dict_size;
  const long long* exc_ptr;
  const long long* exc_index;
  const long long* exc_left;

  __device__ __forceinline__ void decode(Shared& sh, U* vals, long long i,
                                         long long vec) const {
    stage<U, S>(sh.rwords, right + i * rbw * (kVector / S), rbw);
    stage<uint16_t, 16>(sh.lwords, left + i * lbw * (kVector / 16), lbw);
    if (threadIdx.x < 8) sh.entries[threadIdx.x] = dict[i * 8 + threadIdx.x];
    __syncthreads();
    // indexes past the dictionary (exceptions) take its last entry, as in
    // K3/K4; the exception pass below overwrites those slots
    const int last = max(min(dict_size[i], 8) - 1, 0);
    for (int k = threadIdx.x; k < kVector; k += blockDim.x) {
      const U r = rbw ? unpack<U, S>(sh.rwords, rbw, k) : U(0);
      const int idx = lbw ? unpack<uint16_t, 16>(sh.lwords, lbw, k) : 0;
      const U l = sh.entries[min(idx, last)];
      vals[k] = rbw < S ? static_cast<U>(static_cast<U>(l << rbw) | r) : r;
    }
    __syncthreads();
    const long long e1 = exc_ptr[vec + 1];
    if (rbw < S) {
      const U rmask = static_cast<U>((U(1) << rbw) - U(1));
      for (long long e = exc_ptr[vec] + threadIdx.x; e < e1;
           e += blockDim.x) {
        const int k = static_cast<int>(exc_index[e] & (kVector - 1));
        vals[k] = static_cast<U>(
            static_cast<U>(static_cast<U>(exc_left[e]) << rbw) |
            (vals[k] & rmask));
      }
    }
    __syncthreads();
  }

  // The register-resident decode (see the head of this file).  The staged
  // row: the right words, the left words, then the 8 dictionary entries.
  struct Row {
    int last;                                // the last entry indexes take
  };
  __host__ __device__ int right_bytes() const {
    return rbw * (kVector / S) * static_cast<int>(sizeof(U));
  }
  __host__ __device__ int left_bytes() const { return lbw * (kVector / 16) * 2; }
  __host__ __device__ int staged_bytes() const {
    return right_bytes() + left_bytes() + 16;
  }
  __device__ __forceinline__ void stage_async(unsigned char* buf,
                                              long long i) const {
    copy_async(buf, right + i * rbw * (kVector / S), right_bytes());
    copy_async(buf + right_bytes(), left + i * lbw * (kVector / 16),
               left_bytes());
    copy_async(buf + right_bytes() + left_bytes(), dict + i * 8, 16);
  }
  __device__ __forceinline__ Row row(long long i) const {
    return {max(min(dict_size[i], 8) - 1, 0)};
  }
  __device__ __forceinline__ U value(const unsigned char* buf, const Row& r,
                                     int k) const {
    const U rr = rbw ? unpack<U, S>(reinterpret_cast<const U*>(buf), rbw, k)
                     : U(0);
    const int idx =
        lbw ? unpack<uint16_t, 16>(
                  reinterpret_cast<const uint16_t*>(buf + right_bytes()), lbw,
                  k)
            : 0;
    const U l = reinterpret_cast<const uint16_t*>(
        buf + right_bytes() + left_bytes())[min(idx, r.last)];
    return rbw < S ? static_cast<U>(static_cast<U>(l << rbw) | rr) : rr;
  }
  __device__ __forceinline__ bool patches() const { return rbw < S; }
  __device__ __forceinline__ int slot(long long e) const {
    return static_cast<int>(exc_index[e] & (kVector - 1));
  }
  __device__ __forceinline__ U payload(long long e) const {
    return static_cast<U>(exc_left[e]);
  }
  // rbw < S only (patches())
  __device__ __forceinline__ U patch(const unsigned char* buf, const Row& r,
                                     U pay, int k) const {
    const U rmask = static_cast<U>((U(1) << rbw) - U(1));
    return static_cast<U>(static_cast<U>(pay << rbw) |
                          (value(buf, r, k) & rmask));
  }
};

// The exception marks of a RowAhead kernel: kMarks sets of 32 words of
// bits in shared memory.  Row it's slots are marked in set it % kMarks
// during the row before, and a set is cleared two rows after its row.
constexpr int kMarks = 4;

__host__ __device__ constexpr unsigned round16(unsigned b) {
  return (b + 15u) & ~15u;
}

// The end of a RowAhead kernel's dynamic shared memory (byte offsets): the
// marks and two staging buffers of `staged` bytes, from byte `at`.
struct StageLayout {
  unsigned marks, buf[2], bytes;
};

inline StageLayout stage_layout(unsigned at, int staged) {
  StageLayout l{};
  l.marks = at;
  l.buf[0] = at = round16(at + kMarks * 32 * 4u);
  l.buf[1] = at = round16(at + staged);
  l.bytes = round16(at + staged);
  return l;
}

// The rows a block reads at a grid stride, for the kernels that keep
// their values in registers (K17, K19), loaded ahead so that no load of
// global memory waits in the row being read: row i's metadata and its
// exceptions (each thread's slots and payloads, N a thread: a vector holds
// at most 1024) one row ahead, its exception range two rows ahead and its
// vector id three.  ahead() issues the loads of the rows to come, at the
// top of row i; next() moves to row i + step.  Every thread of the block
// calls them the same number of times.
template <class V, int N>
struct RowAhead {
  using U = typename V::U;
  using Row = typename V::Row;
  const V& src;
  const long long* rows;
  long long n, step, i;
  long long vec, vec1, vec2, vec3;           // rows i .. i + 3 step
  long long e0, e1, e0n, e1n, e0nn, e1nn;    // exception ranges, i .. i + 2
  Row rw, rwn;
  int xk[N], xkn[N];                         // slots (-1: none), i and i + 1
  U xp[N], xpn[N];                           // payloads

  __device__ __forceinline__ RowAhead(const V& v, const long long* r,
                                      long long n_rows, long long first)
      : src(v), rows(r), n(n_rows), step(gridDim.x), i(first) {
    vec = id(i);
    vec1 = id(i + step);
    vec2 = id(i + 2 * step);
    vec3 = 0;
    rw = src.row(i < n ? i : 0);
    rwn = rw;
    range(vec, i, e0, e1);
    range(vec1, i + step, e0n, e1n);
    e0nn = e1nn = 0;
    load(e0, e1, xk, xp);
  }
  __device__ __forceinline__ long long id(long long j) const {
    return j < n ? rows[j] : 0;
  }
  __device__ __forceinline__ void range(long long v, long long j,
                                        long long& a, long long& b) const {
    a = b = 0;
    if (j < n && src.patches()) {
      a = src.exc_ptr[v];
      b = src.exc_ptr[v + 1];
    }
  }
  __device__ __forceinline__ void load(long long a, long long b,
                                       int (&k)[N], U (&p)[N]) const {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const long long e = a + threadIdx.x + m * blockDim.x;
      k[m] = e < b ? src.slot(e) : -1;
      p[m] = e < b ? src.payload(e) : U(0);
    }
  }
  __device__ __forceinline__ void ahead() {
    if (i + step < n) rwn = src.row(i + step);
    vec3 = id(i + 3 * step);
    range(vec2, i + 2 * step, e0nn, e1nn);
    load(e0n, e1n, xkn, xpn);
  }
  __device__ __forceinline__ void next() {
    i += step;
    vec = vec1;
    vec1 = vec2;
    vec2 = vec3;
    rw = rwn;
    e0 = e0n;
    e1 = e1n;
    e0n = e0nn;
    e1n = e1nn;
#pragma unroll
    for (int m = 0; m < N; ++m) {
      xk[m] = xkn[m];
      xp[m] = xpn[m];
    }
  }
};

// The exception slots k[] into a block's mark set (32 words of bits).
template <int N>
__device__ __forceinline__ void mark_slots(unsigned* set,
                                           const int (&k)[N]) {
#pragma unroll
  for (int m = 0; m < N; ++m)
    if (k[m] >= 0) atomicOr(&set[k[m] >> 5], 1u << (k[m] & 31));
}

// Blocks for n vectors on card `dev` (the card of the tensors): as many
// blocks of `threads` threads and `dyn` bytes of dynamic shared memory as
// can be resident at once (at most one per vector); each walks its share
// of the vectors.
template <typename K>
cudaError_t grid_for(K kernel, long long n, int dev, int threads, size_t dyn,
                     unsigned* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, dyn);
  const long long cap = max(static_cast<long long>(sms) * per_sm, 1ll);
  *blocks = static_cast<unsigned>(n < cap ? n : cap);
  return err;
}

// The routes of a bucket's C arguments, shared by the kernels that read
// vectors through them (keys.cu, group.cu).
template <typename F>
AlpVector<F> alp_route(const void* packed, int bw, const void* base,
                       const void* fact, const void* frac,
                       const void* exc_ptr, const void* exc_index,
                       const void* exc_bits) {
  using U = typename Num<F>::U;
  return {static_cast<const U*>(packed), bw, static_cast<const U*>(base),
          static_cast<const U*>(fact), static_cast<const F*>(frac),
          static_cast<const long long*>(exc_ptr),
          static_cast<const long long*>(exc_index),
          static_cast<const U*>(exc_bits)};
}

template <typename U, int S>
RdVector<U, S> rd_route(const void* right, int rbw, const void* left,
                        int lbw, const void* dict, const void* dict_size,
                        const void* exc_ptr, const void* exc_index,
                        const void* exc_left) {
  return {static_cast<const U*>(right), rbw,
          static_cast<const uint16_t*>(left), lbw,
          static_cast<const uint16_t*>(dict),
          static_cast<const int*>(dict_size),
          static_cast<const long long*>(exc_ptr),
          static_cast<const long long*>(exc_index),
          static_cast<const long long*>(exc_left)};
}

inline bool bad_alp(int bw, int S) { return bw < 0 || bw > S; }
inline bool bad_rd(int rbw, int lbw, int S) {
  return rbw < 0 || rbw > S || lbw < 0 || lbw > 16;
}

}  // namespace alp

// The C arguments of an ALP bucket (K1/K2's, the rows, the plan's ALP
// exception CSR with the true bits) and of an ALP_RD bucket (K3/K4's, the
// rows, the RD exception CSR with the raw left parts), and their routes.
#define ALP_ARGS                                                          \
  const void *packed, int bw, const void *base, const void *fact,         \
      const void *frac, const void *rows, const void *exc_ptr,            \
      const void *exc_index, const void *exc_bits, long long n,           \
      long long n_values
#define RD_ARGS                                                           \
  const void *right, int rbw, const void *left, int lbw, const void *dict, \
      const void *dict_size, const void *rows, const void *exc_ptr,       \
      const void *exc_index, const void *exc_left, long long n,           \
      long long n_values
#define ALP_ROUTE(F)                                                      \
  alp::alp_route<F>(packed, bw, base, fact, frac, exc_ptr, exc_index,     \
                    exc_bits)
#define RD_ROUTE(U, S)                                                    \
  alp::rd_route<U, S>(right, rbw, left, lbw, dict, dict_size, exc_ptr,    \
                      exc_index, exc_left)
