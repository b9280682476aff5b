"""CUDA-event ablations of K17 ``rank_pass`` and K19 ``group_reduce`` on
the card: what each part of the two kernels costs, and how the variants
that were weighed against them compare.

Run from the root of a checkout on a machine with one NVIDIA card::

    python3 kernel_ablations.py

Each variant is the sources of ``alp_tpu_torch/csrc`` with a few text
edits (``VARIANTS``), built beside the library in the ignored
``alp_tpu_torch/_build/ablate/`` (every source compiled once, then only the
edited ones again, all in parallel) and timed on the 256 MiB columns of
``chip_smoke.py`` (``COLUMNS``) at its timing shapes: K17 at R = 8, T = 2048 on 8
disjoint brackets and on a later pass (8 bands of 0.1 %), K19 at G = 16
and 65,536 random ids and at 16 ordered runs.  A variant marked exact must
give its plain version's outputs bit for bit (the script fails
otherwise); the ablations (a part removed) give wrong outputs and are
timed only.  Prints the card and its power limit, a line a column and a
JSON object of every time, in milliseconds (CUDA events, 20 launches
after a warm-up, as ``chip_smoke.cuda_ms``).
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
COLUMNS = ("bench_bw11_city_temperature", "bench_bw42_nyc29",
           "bench_bw0_gov26", "f64_alp_rd", "f32_alp", "f32_alp_rd")

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
    # rows staged two ahead (three buffers)
    "k17_stage_2_ahead": (True, {"keys.cu": [
        ("  unsigned hist, qbin, xval;\n",
         "  unsigned hist, qbin, xval, buf2;\n"),
        ("  static_cast<alp::StageLayout&>(l) = stage_layout(at, staged);\n",
         """  static_cast<alp::StageLayout&>(l) = stage_layout(at, staged);
  l.buf2 = l.bytes;
  l.bytes = round16(l.buf2 + staged);
"""),
        ("""  if (i < n) src.stage_async(buf0, i);
  commit_async();
  // the tree""", """  if (i < n) src.stage_async(buf0, i);
  commit_async();
  if (i + gridDim.x < n) src.stage_async(buf1, i + gridDim.x);
  commit_async();
  // the tree"""),
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
    # K19 without its path for a warp of one group
    "k19_no_warp_path": (True, {"group.cu": [(_WARP_PATH, _WARP_PATH.replace(
        "real && g == g0)", "real && g == g0) && g0 < 0"))]}),
}


def ptxas_lines(log: str) -> list:
    """"<kernel> <route>: <registers, spills, shared memory>" of K17 and
    K19 from nvcc's -Xptxas -v log."""
    out, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            kernel = next((k for k in ("rank_pass", "group_reduce")
                           if k in name), None)
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


def build_variants(names, build, nvcc) -> dict:
    """name -> loaded ctypes library of each variant (and "base"), every
    object compiled in parallel: each source once, then each variant's
    edited sources."""
    shutil.rmtree(BUILD, ignore_errors=True)
    src_dir = ROOT / "alp_tpu_torch" / "csrc"
    sources = sorted(src_dir.glob("*.cu"))
    jobs = []                            # (variant, source name, path)
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
            if name == "base" or src.name in edits:
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
        edited = {} if name == "base" else VARIANTS[name][1]
        objs = [BUILD / (name if name == "base" or s.name in edited
                         else "base") / f"{s.stem}.o" for s in sources]
        so = BUILD / name / "lib.so"
        subprocess.run([nvcc, *build.ARCH, "-shared", "-o", str(so),
                        *map(str, objs)], check=True)
        dll = ctypes.CDLL(str(so))
        for entry, argtypes in build.ENTRIES.items():
            fn = getattr(dll, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[name] = dll
        for f in ("keys.cu", "group.cu"):
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
    from alp_tpu_torch import engine
    from alp_tpu_torch.columns import BENCH_PROFILES, route_columns
    from alp_tpu_torch.columns import tile_column
    from alp_tpu_torch.kernels import _build
    from alp_tpu_torch.kernels import group as kgroup
    from alp_tpu_torch.kernels import keys as kkeys
    from alp_tpu_torch.ops.keys import biased_keys

    dev = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)
    libs = build_variants(list(VARIANTS), _build, _build.nvcc_path())
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
            for label, (thr, br) in (
                    ("k17 disjoint", (cs.column_thresholds(x, T),
                                      cs.disjoint_brackets(x, R))),
                    ("k17 later", cs.later_pass_case(torch.sort(bk).values,
                                                     R, T))):
                thr_t = cs.thresholds_tensor(thr, plan)
                br_t = cs.thresholds_tensor(br, plan)
                want = [c.rank_pass_plain(thr_t, br_t) for c in kcalls]
                for lname, dll in libs.items():
                    if not lname.startswith(("base", "k17")):
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
    print(json.dumps({"ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
