"""CUDA-event ablations of the key kernels K15 ``key_counts``, K16
``key_extremes`` and K17 ``rank_pass``, of the grouped kernels K18
``vector_sum_extremes`` and K19 ``group_reduce`` and of the bench's K20
``variant_sum_f64`` on the card: what each part of the kernels costs, and
how the variants that were weighed against them compare.

Run from the root of a checkout on a machine with one NVIDIA card::

    python3 kernel_ablations.py

Each variant is the sources of ``alp_tpu_torch/csrc`` with a few text
edits (``VARIANTS``), built beside the library in the ignored
``alp_tpu_torch/_build/ablate/`` (every source compiled once, then the
edited ones again, every source where a header is edited, all in
parallel) and timed on the 256 MiB columns of ``chip_smoke.py``
(``COLUMNS``) at its timing shapes: K15 at E = 2, 7 (the bench's
histogram) and 16 (``K15_E``; the few-threshold path against the search
tree) and at 17 and 2048, K16, K17 at R = 8, T = 2048 on 8
disjoint brackets and on a later pass (8 bands of 0.1 %), K18 on every
bucket, K19 at G = 16 and 65,536 random ids and at 16 ordered runs, and
K20 on the f64 ALP buckets.  K18's variants: ``k18_atomic_settle`` (the
first design's settle, 64-bit shared atomics into a row, on the present
row loop; exact), ``k18_256_threads`` (blocks of 256, 4 values a thread;
exact), ``k18_no_digits`` and ``k18_no_keys`` (the digit sums or the key
extremes removed).  K20's: ``k20_slot_unpack`` (the first design,
``unpack()`` for every slot; exact), ``k20_word_loop`` (the lane word by
word, one field at a time; exact), ``k20_direct`` (each field's words
loaded where it is taken; exact), ``k20_magic_convert``
(the int64 -> double convert by the 2^52 magic add where |m| < 2^51;
exact) and ``k20_no_convert`` (the convert removed).  A variant marked
exact must give its plain version's outputs bit for bit (the script fails
otherwise); the ablations (a part removed) give wrong outputs and are
timed only.  Prints the card and its power limit, the ptxas line of each
rebuilt kernel, K20's loops in the SASS of each K20 variant (``cuobjdump
-sass``: the instructions of each loop body a slot, one float add a slot),
a line a column and a JSON object of every time, in milliseconds (CUDA
events, 20 launches after a warm-up, as ``chip_smoke.cuda_ms``).
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
BUILD = ROOT / "alp_tpu_torch" / "_build" / "ablate"
COLUMNS = ("bench_bw11_city_temperature", "bench_bw20_food_prices",
           "bench_bw30_bitcoin", "bench_bw42_nyc29", "bench_bw0_gov26",
           "f64_alp_rd", "f32_alp", "f32_alp_rd")
K15_E = (2, 7, 16, 17, 2048)        # K15's thresholds a timing

# K17's row loop and its parts, as csrc/keys.cu has them
_RANK_CALL = "    rank_keys(key, real, tab);\n"
_BRACKETS = "    if (real[j] && key[j] >= t.ulo && key[j] <= t.uhi) {"
_SEARCH = "  t.tree.bins(key, p);"
_BINS = "    count_bin(real[j], p[j], t.hist);"
_BOUNDS = "__global__ void __launch_bounds__(kThreads)\nrank_pass_kernel("
_TREE_LOOP = """    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        at[j] = 2 * at[j] + (node[at[j]] < key[j]);
    }"""
_TREE_BUILD = "      w[at] = s < n ? thr[s] : static_cast<U>(~U(0));"
_WARP_PATH = "    if (__all_sync(kFull, real && g == g0))\n      add_warp(g0, b);"

# the key kernels' row loop (vector.cuh), K15's few-threshold path and
# K16's merge (keys.cu)
_PATCH = ("      if (marked && ((mk[k >> 5] >> (k & 31)) & 1u))\n"
          "        b = src.patch(buf, ra.rw, xv[k], k);\n")
_VALUE = "      U b = src.value(buf, ra.rw, k);\n"
_STORE_FIRST = ("  store_exceptions<T>(src, ra.e0, ra.e1, marks, xval, ra.xk, "
                "ra.xp);\n")
_STORE_NEXT = """    store_exceptions<T>(src, ra.e0n, ra.e1n,
                        marks + 32 * ((it + 1) % kMarks),
                        xval + ((it + 1) & 1) * kVector, ra.xkn, ra.xpn);
"""
_SMALL = "  if (E <= kSmall) {"
_K_SMALL = "constexpr int kSmall = 2;"
_COUNT_SMALL = """  U k[N];
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
  }"""
_K16_SLOTS = """  __shared__ U wlo[kKeyWarps], whi[kKeyWarps];   // a warp's pair
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
"""
_K16_MERGE = """    if (lane == 0) {
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
}"""

# K18 (group.cu) and K20 (falp.cu), as the sources have them
_K18_STORE = "    acc.store(s.part[warp], &s.base[warp]);\n"
_K18_KEYS = """      if (real[j]) {
        lo = umin(lo, key[j]);
        hi = umax(hi, key[j]);
      }
"""
_K20_STREAM = """\
    alp::LaneStream in(packed + vec * bw * kLanes64 + lane, bw);
    for (int s = 0; s < kSlots64; s += kSumStep) {
      float t[kSumStep];
#pragma unroll
      for (int q = 0; q < kSumStep; ++q) t[q] = cut(in.next());
#pragma unroll
      for (int q = 0; q < kSumStep; ++q) acc = __fadd_rn(acc, t[q]);
    }
"""
_K20_DECODE = """    return trunc_f32(Num<double>::bits(
        Num<double>::decode(static_cast<uint64_t>((b + u) * f), fr)));
"""

# name -> (exact, {source file: [(old, new), ...]})
VARIANTS = {
    # the parts of K17, each removed in turn (the outputs are wrong)
    "k17_no_brackets": (False, {"keys.cu": [(_BRACKETS, "    if (false) {")]}),
    "k17_no_search": (False, {"keys.cu": [(_SEARCH, """#pragma unroll
  for (int j = 0; j < N; ++j)
    p[j] = static_cast<int>(key[j] & (t.tree.L >= 10 ? 1023 : 0));""")]}),
    "k17_no_bins": (False, {"keys.cu": [(_BINS, "    if (p[j] == -7) "
                                                "count_bin(real[j], p[j], "
                                                "t.hist);")]}),
    # more blocks an SM at fewer registers (spills)
    "k17_5_blocks": (True, {"keys.cu": [(_BOUNDS, _BOUNDS.replace(
        "(kThreads)", "(kThreads, 5)"))]}),
    "k17_6_blocks": (True, {"keys.cu": [(_BOUNDS, _BOUNDS.replace(
        "(kThreads)", "(kThreads, 6)"))]}),
    # a thread's keys one or two at a time instead of four in lockstep
    "k17_1_key": (True, {"keys.cu": [(_RANK_CALL, """#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const U k1[1] = {key[j]};
      const bool r1[1] = {real[j]};
      rank_keys(k1, r1, tab);
    }
""")]}),
    "k17_2_keys": (True, {"keys.cu": [(_RANK_CALL, """#pragma unroll
    for (int j = 0; j < kPer; j += 2) {
      const U k2[2] = {key[j], key[j + 1]};
      const bool r2[2] = {real[j], real[j + 1]};
      rank_keys(k2, r2, tab);
    }
""")]}),
    # an f64 node in two 32-bit halves: the low one read only on a tie
    "k17_split_f64": (True, {"keys.cu": [
        (_TREE_BUILD, """      const U v = s < n ? thr[s] : static_cast<U>(~U(0));
      if (sizeof(U) == 8) {
        auto* h = reinterpret_cast<uint32_t*>(w);
        h[at] = static_cast<uint32_t>(static_cast<uint64_t>(v) >> 32);
        h[(1 << L) + at] = static_cast<uint32_t>(v);
      } else {
        w[at] = v;
      }"""),
        (_TREE_LOOP, """    if (sizeof(U) == 8) {
      const auto* hi = reinterpret_cast<const uint32_t*>(node);
      const uint32_t* lo = hi + (1 << L);
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const uint32_t kh = static_cast<uint32_t>(
              static_cast<uint64_t>(key[j]) >> 32);
          const uint32_t h = hi[at[j]];
          bool below = h < kh;
          if (h == kh) below = lo[at[j]] < static_cast<uint32_t>(key[j]);
          at[j] = 2 * at[j] + below;
        }
      }
    } else {
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int j = 0; j < N; ++j)
          at[j] = 2 * at[j] + (node[at[j]] < key[j]);
      }
    }""")]}),
    # one vote for a thread's keys before the bracket slots
    "k17_one_vote": (True, {"keys.cu": [("""#pragma unroll
  for (int j = 0; j < N; ++j) bracket_key(key[j], m[j], t.wlo, t.whi);
}""", """  bool more = false;
  const volatile U* vlo = t.wlo;
  const volatile U* vhi = t.whi;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (m[j]) {
      const int b = __ffs(m[j]) - 1;
      more |= (m[j] & (m[j] - 1)) != 0 || key[j] < vlo[b] || key[j] > vhi[b];
    }
  if (__any_sync(kFull, more)) {
#pragma unroll
    for (int j = 0; j < N; ++j) bracket_key(key[j], m[j], t.wlo, t.whi);
  }
}""")]}),
    # the row loop with its rows staged two ahead (three buffers)
    "keys_stage_2_ahead": (True, {"vector.cuh": [
        ("  unsigned xval;\n", "  unsigned xval, buf2;\n"),
        ("""      stage_layout(round16(l.xval + 2 * kVector * key_bytes), staged);
  return l;""", """      stage_layout(round16(l.xval + 2 * kVector * key_bytes), staged);
  l.buf2 = l.bytes;
  l.bytes = round16(l.buf2 + staged);
  return l;"""),
        ("""  if (blockIdx.x < n) src.stage_async(dyn + lay.buf[0], blockIdx.x);
  commit_async();""", """  if (blockIdx.x < n) src.stage_async(dyn + lay.buf[0], blockIdx.x);
  commit_async();
  if (blockIdx.x + gridDim.x < n)
    src.stage_async(dyn + lay.buf[1], blockIdx.x + gridDim.x);
  commit_async();"""),
        ("""    wait_async();
    __syncthreads();                         // row i staged and marked
    const unsigned char* buf = it & 1 ? buf1 : buf0;
    if (nxt < n) src.stage_async(it & 1 ? buf0 : buf1, nxt);
    commit_async();""", """    asm volatile("cp.async.wait_group 1;\\n" ::: "memory");
    __syncthreads();                         // row i staged and marked
    const unsigned bufs[3] = {lay.buf[0], lay.buf[1], lay.buf2};
    const unsigned char* buf = dyn + bufs[it % 3];
    if (nxt + gridDim.x < n)
      src.stage_async(dyn + bufs[(it + 2) % 3], nxt + gridDim.x);
    commit_async();""")]}),
    # the row loop without its exceptions (no marks, no payloads, no
    # patch): wrong where a vector holds one
    "keys_no_exceptions": (False, {"vector.cuh": [
        (_PATCH, ""), (_STORE_FIRST, ""), (_STORE_NEXT, "")]}),
    # the row loop without the decode: a payload slot's word a value
    "keys_no_decode": (False, {"vector.cuh": [(_VALUE, """      U b = static_cast<U>(k) ^ xv[k];
""")]}),
    # K15's few-threshold path forced onto the search tree
    "k15_tree": (True, {"keys.cu": [(_SMALL, _SMALL.replace("kSmall", "0"))]}),
    # K15's few-threshold path at up to 16 thresholds (padded to 16)
    "k15_small_16": (True, {"keys.cu": [(_K_SMALL, _K_SMALL.replace(
        "2;", "16;"))]}),
    # K15's few-threshold path without its counts: the row loop alone, the
    # keys folded into one count so that the decode stays
    "k15_no_bins": (False, {"keys.cu": [(_COUNT_SMALL, """  U k = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) k ^= real[j] ? key[j] : U(0);
  above[0] += static_cast<unsigned>(k) & 1u;""")]}),
    # K16 merged by warp 0, which takes the last row's pairs (slots of two
    # parities) after the next row's barrier: no second barrier a vector
    "k16_warp_merge": (True, {"keys.cu": [
        (_K16_SLOTS, """  __shared__ U wlo[2][kKeyWarps], whi[2][kKeyWarps];
  __shared__ long long wvec[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int it = 0;
  const auto merge = [&](int s) {
    U lo = lane < kKeyWarps ? wlo[s][lane] : static_cast<U>(~U(0));
    U hi = lane < kKeyWarps ? whi[s][lane] : U(0);
    warp_extremes(lo, hi);
    if (lane < 2) out[2 * wvec[s] + lane] = lane ? hi : lo;
  };
"""),
        (_K16_MERGE, """    if (lane == 0) {
      wlo[it & 1][warp] = lo;
      whi[it & 1][warp] = hi;
      if (warp == 0) wvec[it & 1] = vec;
    }
    if (warp == 0 && it > 0) merge((it - 1) & 1);
    ++it;
  });
  __syncthreads();
  if (warp == 0 && it > 0) merge((it - 1) & 1);
}""")]}),
    # K18 with the first design's settle (64-bit shared atomics of each
    # warp's windows into the parity's row) on the row loop
    "k18_atomic_settle": (True, {"group.cu": [(_K18_STORE, """    acc.settle();
    if (lane == 0) s.base[warp] = -1;
""")]}),
    # K18 without its digit sums, and without its key extremes
    "k18_no_digits": (False, {"group.cu": [("    acc.add(b, real);\n", "")]}),
    "k18_no_keys": (False, {"group.cu": [
        (_K18_KEYS, ""), ("    warp_extremes(lo, hi);\n", "")]}),
    # K18 in blocks of 256 threads, 4 values a thread
    "k18_256_threads": (True, {"group.cu": [(
        "constexpr int kSumThreads = 128;",
        "constexpr int kSumThreads = 256;")]}),
    # K20's first design: unpack() of every slot from the packed words
    "k20_slot_unpack": (True, {"falp.cu": [(_K20_STREAM, """\
    const uint64_t* words = packed + vec * bw * kLanes64;
    for (int s = 0; s < kSlots64; ++s)
      acc = __fadd_rn(acc, cut(unpack<uint64_t, 64>(words, bw,
                                                    s * kLanes64 + lane)));
""")]}),
    # K20 word by word, one field at a time: the fields that start in the
    # current word, then one rotation of the words
    "k20_word_loop": (True, {"falp.cu": [(_K20_STREAM, """\
    const uint64_t* lanep = packed + vec * bw * kLanes64 + lane;
    const uint64_t mask = bw >= 64 ? ~0ull : (1ull << bw) - 1;
    uint64_t cur = lanep[0];
    uint64_t nxt = bw > 1 ? lanep[kLanes64] : 0;
    uint64_t ahead = bw > 2 ? lanep[2 * kLanes64] : 0;
    int s = 0, off = 0;
    for (int w = 0; s < kSlots64; ++w) {
      for (; s < kSlots64 && off < 64; ++s, off += bw)
        acc = __fadd_rn(acc, cut(alp::funnel_r(cur, nxt, off) & mask));
      off -= 64;
      cur = nxt;
      nxt = ahead;
      ahead = w + 3 < bw ? lanep[(w + 3) * kLanes64] : 0;
    }
""")]}),
    # K20 with each field's one or two words loaded where it is taken (L1
    # hits after the first), in steps of 4
    "k20_direct": (True, {"falp.cu": [(_K20_STREAM, """\
    const uint64_t* lanep = packed + vec * bw * kLanes64 + lane;
    const uint64_t mask = bw >= 64 ? ~0ull : (1ull << bw) - 1;
    for (int s = 0; s < kSlots64; s += kSumStep) {
      float t[kSumStep];
#pragma unroll
      for (int q = 0; q < kSumStep; ++q) {
        const int off = (s + q) * bw, w0 = off >> 6, s0 = off & 63;
        t[q] = cut(alp::funnel_r(lanep[w0 * kLanes64],
                                 s0 + bw > 64 ? lanep[(w0 + 1) * kLanes64]
                                              : 0ull,
                                 s0) & mask);
      }
#pragma unroll
      for (int q = 0; q < kSumStep; ++q) acc = __fadd_rn(acc, t[q]);
    }
""")]}),
    # K20's int64 -> double by the 2^52 magic add where |m| < 2^51 (exact
    # there), the convert elsewhere
    "k20_magic_convert": (True, {"falp.cu": [(_K20_DECODE, """\
    const long long m = static_cast<long long>((b + u) * f);
    return trunc_f32(Num<double>::bits(__dmul_rn(
        static_cast<unsigned long long>(m + (1ll << 51)) < (1ull << 52)
            ? __dsub_rn(__longlong_as_double(m + 0x4338000000000000ll),
                        6755399441055744.0)
            : __ll2double_rn(m),
        fr)));
""")]}),
    # K20 without the int64 -> double convert (the integer's bits taken as
    # a double)
    "k20_no_convert": (False, {"falp.cu": [(_K20_DECODE, """\
    return trunc_f32(Num<double>::bits(__dmul_rn(
        __longlong_as_double(static_cast<long long>((b + u) * f)), fr)));
""")]}),
    # K19 without its path for a warp of one group
    "k19_no_warp_path": (True, {"group.cu": [(_WARP_PATH, _WARP_PATH.replace(
        "real && g == g0)", "real && g == g0) && g0 < 0"))]}),
}


def ptxas_lines(log: str) -> list:
    """"<kernel> <route>: <registers, spills, shared memory>" of K15-K20
    from nvcc's -Xptxas -v log."""
    out, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            kernel = next((k for k in ("key_counts_small", "key_counts",
                                       "key_extremes", "rank_pass",
                                       "vector_sums", "group_reduce",
                                       "variant_sum") if k in name), None)
            route = next((r for t, r in (("AlpVectorId", "ALP f64"),
                                         ("AlpVectorIf", "ALP f32"),
                                         ("RdVectorIm", "RD f64"),
                                         ("RdVectorIj", "RD f32"))
                          if t in name), "")
            shared = "Lb1E" in name
            entry = (f"{kernel} {route}"
                     f"{' shared' if kernel == 'group_reduce' and shared else ''}"
                     f"{' device' if kernel == 'group_reduce' and not shared else ''}"
                     if kernel else None)
        elif entry and "Used" in ln and "registers" in ln:
            out.append(f"{entry} {ln.split('info    :')[-1].strip()}")
            entry = None
    return out


def sass_loops(obj: pathlib.Path, cuobjdump: str, kernel: str) -> list:
    """The loops of `kernel` in the SASS of object `obj` that hold a float
    add (K20's slot loops: one FADD a slot), innermost first: for each, the
    instructions from the target of its backward branch to the branch, its
    FADDs, I2F, DMUL and global loads, and its instructions a slot.  A code
    block the compiler placed outside that range is not counted."""
    sass = subprocess.run([cuobjdump, "-sass", str(obj)], check=True,
                          capture_output=True, text=True).stdout
    body, inside = [], False                 # (address, opcode, operands)
    for ln in sass.splitlines():
        s = ln.strip()
        if "Function :" in s:
            inside = kernel in s
        elif inside and s.startswith("/*") and ";" in s:
            words = s.split("*/", 1)[1].split(";")[0].split()
            if words[0].startswith("@"):     # a predicate
                words = words[1:]
            body.append((int(s[2:].split("*/")[0], 16), words[0],
                         words[1:]))
    loops = []
    for at, op, args in body:
        if not op.startswith("BRA") or not args[-1].startswith("0x"):
            continue
        to = int(args[-1], 16)
        span = [o for a, o, _ in body if to <= a <= at]
        count = {k: sum(o.startswith(k) for o in span)
                 for k in ("FADD", "I2F", "DMUL", "LDG")}
        if to < at and count["FADD"]:
            loops.append(dict(count, instructions=len(span),
                              per_slot=len(span) / count["FADD"]))
    if not loops:
        raise SystemExit(f"no loop with a float add in {kernel} of {obj}")
    return sorted(loops, key=lambda c: c["instructions"])


def build_variants(names, build, nvcc) -> dict:
    """name -> loaded ctypes library of each variant (and "base"), every
    object compiled in parallel: each source once, then each variant's
    edited sources."""
    shutil.rmtree(BUILD, ignore_errors=True)
    src_dir = ROOT / "alp_tpu_torch" / "csrc"
    sources = sorted(src_dir.glob("*.cu"))
    jobs = []                            # (variant, source name, path)

    def rebuilt(name, src):
        """Whether variant `name` compiles `src` itself (else base's)."""
        edits = {} if name == "base" else VARIANTS[name][1]
        return name == "base" or src.name in edits or any(
            f.endswith(".cuh") for f in edits)

    for name in ["base", *names]:
        d = BUILD / name
        shutil.copytree(src_dir, d)
        edits = {} if name == "base" else VARIANTS[name][1]
        for f, pairs in edits.items():
            text = (d / f).read_text()
            for old, new in pairs:
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: the edit of {f} does not "
                                     f"apply: {old[:60]!r}")
                text = text.replace(old, new)
            (d / f).write_text(text)
        for src in sources:
            if rebuilt(name, src):
                jobs.append((name, src.name, d / src.name))
    procs = [(n, s, subprocess.Popen(
        [nvcc, *build.FLAGS, "-c", "-o", str(p.with_suffix(".o")), str(p)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for n, s, p in jobs]
    logs = {}
    for n, s, p in procs:
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{n}/{s} does not build:\n{out}")
        logs[n, s] = out
    libs = {}
    for name in ["base", *names]:
        objs = [BUILD / (name if rebuilt(name, s) else "base")
                / f"{s.stem}.o" for s in sources]
        so = BUILD / name / "lib.so"
        subprocess.run([nvcc, *build.ARCH, "-shared", "-o", str(so),
                        *map(str, objs)], check=True)
        dll = ctypes.CDLL(str(so))
        for entry, argtypes in build.ENTRIES.items():
            fn = getattr(dll, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[name] = dll
        for f in ("keys.cu", "group.cu", "falp.cu"):
            if (name, f) in logs:
                print(f"  {name}: {'; '.join(ptxas_lines(logs[name, f]))}",
                      flush=True)
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_ablations.py: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import alp_tpu_torch
    import chip_smoke as cs
    from alp_tpu_torch import constants as C
    from alp_tpu_torch import engine
    from alp_tpu_torch.columns import BENCH_PROFILES, route_columns
    from alp_tpu_torch.columns import tile_column
    from alp_tpu_torch.kernels import _build, falp
    from alp_tpu_torch.kernels import exact_sum as kes
    from alp_tpu_torch.kernels import group as kgroup
    from alp_tpu_torch.kernels import keys as kkeys
    from alp_tpu_torch.ops.keys import biased_keys

    dev = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)
    nvcc = _build.nvcc_path()
    libs = build_variants(list(VARIANTS), _build, nvcc)
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    sass = {}
    for lname in ("base", *(v for v in VARIANTS if v.startswith("k20"))):
        sass[lname] = sass_loops(BUILD / lname / "falp.o", cuobjdump,
                                 "variant_sum_kernel")
        print(f"  K20 SASS {lname}: {sass[lname]}", flush=True)
    real_lib = _build.lib
    tile_to = dict(cs.TILE_TO, **{n: cs.BENCH_VECTORS for n in BENCH_PROFILES})
    sources = route_columns(np.random.default_rng(0), cs.SOURCE_VECTORS)
    R, T = cs.RANK_TIMED
    result = {}
    try:
        for name in COLUMNS:
            col = alp_tpu_torch.compress(sources[name])
            if name in tile_to:
                col = tile_column(col, tile_to[name])
            plan = col.plan(dev)
            bits = plan.run().view(plan.bits_dtype)
            x = bits.reshape(-1)[:plan.n_values].cpu().numpy().view(
                np.float64 if plan.f64 else np.float32)
            bk = biased_keys(bits.reshape(-1)[:plan.n_values])
            del bits
            cells = {}
            kcalls, gcalls = engine.key_calls(plan), engine.group_calls(plan)
            for E in K15_E:
                thr_t = cs.thresholds_tensor(cs.column_thresholds(x, E), plan)
                want = [c.counts_plain(thr_t) for c in kcalls]
                for lname, dll in libs.items():
                    if not lname.startswith(("base", "k15", "keys")) or (
                            lname == "k15_no_bins" and E != 2):
                        continue
                    _build.lib = lambda dll=dll: dll
                    if lname == "base" or VARIANTS[lname][0]:
                        for c, w in zip(kcalls, want):
                            got = c.counts(thr_t, torch.zeros(
                                E + 1, dtype=torch.int64, device=dev))
                            if not torch.equal(got, w):
                                raise SystemExit(f"{name}: {lname} K15 at "
                                                 f"E={E} differs from its "
                                                 f"plain version")
                    out = torch.zeros(E + 1, dtype=torch.int64, device=dev)
                    cells[f"k15 E={E} {lname}"] = cs.cuda_ms(
                        lambda: [c.counts(thr_t, out) for c in kcalls], 20)
            want = [c.extremes_plain() for c in kcalls]
            for lname, dll in libs.items():
                if not lname.startswith(("base", "k16", "keys")):
                    continue
                _build.lib = lambda dll=dll: dll
                out = torch.zeros((plan.n_vectors, 2), dtype=plan.bits_dtype,
                                  device=dev)
                for c, w in zip(kcalls, want):
                    if (lname == "base" or VARIANTS[lname][0]) and not (
                            torch.equal(c.extremes(out)[c.rows], w)):
                        raise SystemExit(f"{name}: {lname} K16 differs from "
                                         f"its plain version")
                cells[f"k16 {lname}"] = cs.cuda_ms(
                    lambda: [c.extremes(out) for c in kcalls], 20)
            del want
            for label, (thr, br) in (
                    ("k17 disjoint", (cs.column_thresholds(x, T),
                                      cs.disjoint_brackets(x, R))),
                    ("k17 later", cs.later_pass_case(torch.sort(bk).values,
                                                     R, T))):
                thr_t = cs.thresholds_tensor(thr, plan)
                br_t = cs.thresholds_tensor(br, plan)
                want = [c.rank_pass_plain(thr_t, br_t) for c in kcalls]
                for lname, dll in libs.items():
                    if not lname.startswith(("base", "k17", "keys")):
                        continue
                    _build.lib = lambda dll=dll: dll
                    if lname == "base" or VARIANTS[lname][0]:
                        for c, w in zip(kcalls, want):
                            got = c.rank_pass(thr_t, br_t, *kkeys.rank_outputs(
                                len(thr), R, plan.bits_dtype, dev))
                            if not all(map(torch.equal, got, w)):
                                raise SystemExit(f"{name}: {lname} K17 "
                                                 f"differs from its plain "
                                                 f"version")
                    outs = kkeys.rank_outputs(len(thr), R, plan.bits_dtype,
                                              dev)
                    cells[f"{label} {lname}"] = cs.cuda_ms(
                        lambda: [c.rank_pass(thr_t, br_t, *outs)
                                 for c in kcalls], 20)
            want = [c.vector_sums_plain() for c in gcalls]
            row = kes.WINDOWS[plan.bits_dtype] + 3
            for lname, dll in libs.items():
                if not lname.startswith(("base", "k18")):
                    continue
                _build.lib = lambda dll=dll: dll
                # a sentinel, not zeros: every column must be written
                sums = torch.full((plan.n_vectors, row), -7,
                                  dtype=torch.int64, device=dev)
                keys = torch.full((plan.n_vectors, 2), 7,
                                  dtype=plan.bits_dtype, device=dev)
                for c, (ws, wk) in zip(gcalls, want):
                    c.vector_sums(sums, keys)
                    if (lname == "base" or VARIANTS[lname][0]) and not (
                            torch.equal(sums[c.rows], ws)
                            and torch.equal(keys[c.rows], wk)):
                        raise SystemExit(f"{name}: {lname} K18 differs from "
                                         f"its plain version")
                cells[f"k18 {lname}"] = cs.cuda_ms(
                    lambda: [c.vector_sums(sums, keys) for c in gcalls], 20)
            del want
            alp_f64 = [b for b in plan.buckets
                       if plan.f64 and b.scheme == C.SCHEME_ALP]
            want = [falp.variant_sum_plain(b.args[0], b.bw, *b.args[1:])
                    for b in alp_f64]
            for lname, dll in libs.items():
                if not alp_f64 or not lname.startswith(("base", "k20")):
                    continue
                _build.lib = lambda dll=dll: dll
                if lname == "base" or VARIANTS[lname][0]:
                    for b, w in zip(alp_f64, want):
                        got = falp.variant_sum_f64(b.args[0], b.bw,
                                                   *b.args[1:])
                        if not torch.equal(got.view(torch.int32),
                                           w.view(torch.int32)):
                            raise SystemExit(f"{name}: {lname} K20 bw="
                                             f"{b.bw} differs from its plain "
                                             f"version")
                cells[f"k20 {lname}"] = cs.cuda_ms(
                    lambda: [falp.variant_sum_f64(b.args[0], b.bw,
                                                  *b.args[1:])
                             for b in alp_f64], 20)
            del want
            for G, ordered in ((16, False), (65536, False), (16, True)):
                kv = cs.column_group_keys(plan, G, ordered, G)
                gks = [kv[c.rows].contiguous() for c in gcalls]
                want = [c.group_reduce_plain(gk, G)
                        for c, gk in zip(gcalls, gks)]
                for lname, dll in libs.items():
                    if not lname.startswith(("base", "k19")):
                        continue
                    _build.lib = lambda dll=dll: dll
                    for c, gk, w in zip(gcalls, gks, want):
                        got = c.group_reduce(gk, G, *kgroup.group_outputs(
                            G, plan.bits_dtype, dev))
                        if not all(map(torch.equal, got, w)):
                            raise SystemExit(f"{name}: {lname} K19 differs "
                                             f"from its plain version")
                    outs = kgroup.group_outputs(G, plan.bits_dtype, dev)
                    cells[f"k19 G={G}{' ordered' if ordered else ''} "
                          f"{lname}"] = cs.cuda_ms(
                        lambda: [c.group_reduce(gk, G, *outs)
                                 for c, gk in zip(gcalls, gks)], 20)
                del kv, gks, want
            result[name] = cells
            print(f"{name}: " + "; ".join(f"{k} {v:.4f}"
                                          for k, v in cells.items()),
                  flush=True)
            del bk, plan, col
    finally:
        _build.lib = real_lib
    print(json.dumps({"ms": result, "k20_sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
