"""End-to-end query bench of the port on the card (the reference's table 6).

    python -m alp_tpu_torch.bench_e2e [--out DIR] [--seed N]

Counterpart of ``scripts/bench_e2e.py``: ALP on the card against the
competitor codecs on the host.  One line a row on standard output,
``(query, scheme, parallelism, gbps, alp_speedup)``, after the card's
name and power limit on standard error.  With ``--out DIR`` the rows go
to ``DIR/e2e_queries.csv`` through ``reports.speed_report``; without it
nothing is written.  Without a card it exits nonzero.

The column is the ``bench_bw11_city_temperature`` profile of
``columns.py`` (10 rowgroups from the seed), standing in for the
reference's city-temperature sample: compressed on the host and tiled to
32,768 vectors (256 MiB of doubles) for the card's rows, and its values
tiled to as many for the host rows.  GB/s are of the decoded (or, for
compression, the input) bytes.  The rows, in order:

* loop steps, timed by ``benchlib.loop_bench`` (CUDA events, the carry in
  the work's inputs): ``make_sum_step``, ``make_exact_sum_step``,
  ``make_filter_step(-15, 25)``, the same filter without pushdown
  (``DecodePlan.run`` writes the values, then a key compare and count in
  PyTorch), ``make_topk_step(10)``, ``make_histogram_step`` (6 edges) and
  ``make_groupby_step`` at 16 random groups (K19 over the column; the JAX
  script's sorted-path GROUP-BY program is not ported, by design);
* warm walls (host clock, the answer on the host) of ``query_topk``,
  ``query_histogram``, ``query_groupby`` at 16 and 512 groups,
  ``query_median``, ``query_distinct`` and tumbling and sliding
  ``query_window``;
* the first SUM from a fresh ``build_plan`` and from ``plan_store.restore``
  of a snapshot, beside the bound of one pinned upload of the snapshot;
* correctness companions on the 10-rowgroup column: SUM == ``math.fsum``,
  MIN, MAX, TOP-K, histogram, GROUP-BY, MEDIAN and QUANTILE against
  numpy, the no-pushdown filter against ``query_filter_count``; any
  mismatch raises;
* the uncompressed exact SUM: K5 over 256 MiB of finite doubles already
  on the card;
* the competitors' decode: the native codecs of ``native/competitors.cpp``
  (Gorillas, Chimp, Chimp128, Patas, PDE) over 102,400-value chunks at 1,
  8 and 16 threads, best of 3, every output checked bit for bit (PDE
  patched); then zstd level 3 over the same chunks;
* host compress and host decompress (``decompress_host``: the native
  engine, OpenMP over the host's cores, best of 5, bits checked) of the
  f64 values and of them as float32 (128 MiB), the JAX script's "ALP host
  engine" rows, and beside them the card's ``decompress`` wall of both
  (plan build, copies, kernels);
* the device compress as two loop steps, ``make_device_compress_step``
  (planning and encode) and ``make_pack_step``, on 32,000 vectors (320
  rowgroups, 250 MiB) decoded on the card from the tiled column, beside
  ``compress_device``'s wall on the same values; the step takes
  ``k_max=1`` where it gives ``compress_device``'s pairs, else 5;
* the competitors' compression: a memcpy, the native chunked encoders at
  1, 8 and 16 threads (each checked by a decode) and zstd;
* the mesh at world 1 on the card: ``parallel.sharded.sharded_decode``
  over NCCL against the bare decode of the same column, both as warm
  walls.

The JAX script's virtual-mesh block on the CPU is a functional check, not
a speed row; ``tests/test_torch_parallel.py`` holds the sharded paths at
world sizes 1-8 over gloo, so this bench leaves it out.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import math
import os
import socket
import sys
import time

import numpy as np
import torch

from . import columns, engine, native, plan_store
from .benchlib import carry_into_rows, loop_bench
from .competitors import pde_codec, zstd_codec
from .container import compress, decompress, decompress_host
from .device_compress import (compress_device, make_device_compress_step,
                              make_pack_step)
from .engine import LoopStep, carried
from .kernels import exact_sum as kes
from .kernels.decode import resolve_device
from .ops.keys import in_key_range

VECTORS = 32 * 1024            # 256 MiB of doubles
SOURCE_ROWGROUPS = 10
DC_VECTORS = 32000             # 320 rowgroups, 250 MiB
CHUNK = 102400                 # the reference's rowgroup-sized morsels
THREADS = (1, 8, 16)
CODECS = ("gorillas", "chimp", "chimp128", "patas", "pde")
ITERS = 20
EDGES6 = [-40.0, -15.0, 0.0, 10.0, 25.0, 45.0]
HEADER = ("query", "scheme", "parallelism", "gbps", "alp_speedup")
PROFILE = "bench_bw11_city_temperature"


def source_column(seed: int = 0) -> np.ndarray:
    """The bench's source values: the city-temperature profile over
    ``SOURCE_ROWGROUPS`` rowgroups."""
    rng = np.random.default_rng(seed)
    n = SOURCE_ROWGROUPS * columns.RG_VECTORS
    return columns.route_columns(rng, n)[PROFILE]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best(fn, reps: int = 3) -> float:
    """Best host-clock seconds of ``reps`` calls of ``fn``."""
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _wall(fn, dev) -> float:
    """One warm call's wall: ``fn()`` once, then timed once to its end."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


def make_unfused_filter_step(plan, lo: float, hi: float):
    """The filter without pushdown (``scripts/bench_e2e.py`` step_unfused):
    ``DecodePlan.run`` writes every value, then a key compare and a count
    in PyTorch.  ``step.result`` gives the count, a 0-d int64 tensor equal
    to ``query_filter_count`` at carry 0."""
    klo = engine._float_key(lo, plan.dtype)
    khi = engine._float_key(hi, plan.dtype)

    def result(carry, plan):
        bits = carried(plan, carry).run().view(plan.bits_dtype)
        return in_key_range(bits.reshape(-1)[:plan.n_values], klo,
                            khi).sum()

    return LoopStep(result, lambda c, carry: carry ^ c), (plan,)


def _uncompressed_step():
    """K5 over raw doubles [n, 1024], the carry in each row's first word."""
    def result(carry, bits, vec):
        carry_into_rows(bits, carry)
        out = kes.exact_sum_f64(bits, vec, bits.numel())
        carry_into_rows(bits, carry)
        return out

    return LoopStep(result, lambda t, carry: carry ^ t.sum())


class _Rows:
    """The rows so far, each printed as it comes."""

    def __init__(self, out):
        self.rows = []
        self.out = out

    def add(self, query, scheme, parallelism, gbps, speedup="", note=""):
        row = (query, scheme, parallelism, round(gbps, 2), speedup)
        self.rows.append(row)
        print(row, *([note] if note else []), file=self.out, flush=True)
        return gbps


def _loop_rows(r, col, plan, dev, decoded: int) -> float:
    """The loop steps; returns the SUM-shaped row's GB/s."""
    gbps = r.add("SUM-shaped scan (checksum reduce; loop step)", "ALP",
                 "1 card", decoded / loop_bench(
                     *engine.make_sum_step(plan), ITERS, device=dev) / 1e9,
                 1.0)
    for label, made in (
            ("SUM exact (== math.fsum; fused; loop step)",
             engine.make_exact_sum_step(plan)),
            ("FILTER COUNT (predicate pushdown; loop step)",
             engine.make_filter_step(plan, -15.0, 25.0)),
            ("FILTER COUNT (plane decode; no pushdown; loop step)",
             make_unfused_filter_step(plan, -15.0, 25.0)),
            ("TOP-K (k=10; loop step)", engine.make_topk_step(plan, 10)),
            ("HISTOGRAM (6 edges; loop step)",
             engine.make_histogram_step(plan, EDGES6))):
        r.add(label, "ALP", "1 card",
              decoded / loop_bench(*made, ITERS, device=dev) / 1e9)
    keys16 = np.random.default_rng(3).integers(0, 16, col.n_values)
    r.add("GROUP-BY SUM+MIN/MAX (16 random groups; K19 loop step; the "
          "sorted-path program is not ported, by design)", "ALP", "1 card",
          decoded / loop_bench(*engine.make_groupby_step(col, keys16, 16,
                                                         plan),
                               ITERS // 2, device=dev) / 1e9)
    return gbps


def _wall_rows(r, col, dev, decoded: int) -> None:
    rng = np.random.default_rng(3)
    keys16 = rng.integers(0, 16, col.n_values)
    keys512 = rng.integers(0, 512, col.n_values)
    for label, q in (
            ("TOP-K (k=10; warm wall)",
             lambda: engine.query_topk(col, 10, device=dev)),
            ("HISTOGRAM (6 edges; warm wall)",
             lambda: engine.query_histogram(col, EDGES6, device=dev)),
            ("GROUP-BY (16 groups; warm wall)",
             lambda: engine.query_groupby(col, keys16, 16, device=dev)),
            ("GROUP-BY (512 groups; warm wall)",
             lambda: engine.query_groupby(col, keys512, 512, device=dev)),
            ("MEDIAN (exact rank-select; warm wall)",
             lambda: engine.query_median(col, device=dev)),
            ("DISTINCT COUNT (warm wall)",
             lambda: engine.query_distinct(col, device=dev)),
            ("WINDOW tumbling 1M SUM (warm wall)",
             lambda: engine.query_window(col, 1 << 20, aggs=("sum", "count"),
                                         device=dev)),
            ("WINDOW sliding 1M/256K SUM (warm wall)",
             lambda: engine.query_window(col, 1 << 20, aggs=("sum", "count"),
                                         hop=1 << 18, device=dev))):
        r.add(label, "ALP", "1 card", decoded / _wall(q, dev) / 1e9)


def _cold_rows(r, col, plan, dev, decoded: int) -> None:
    """The first SUM from a fresh plan: built, or restored from a
    snapshot, beside one pinned upload of the snapshot."""
    blob = plan_store.snapshot(plan)
    host = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    if dev.type == "cuda":
        host = host.pin_memory()
    bound_s = _wall(lambda: host.to(dev, non_blocking=True), dev)
    bound = decoded / bound_s / 1e9
    print(f"# cold: snapshot {len(blob) / 1e6:.1f} MB "
          f"({plan_store.snapshot_codec(blob)}); one pinned upload = "
          f"{bound:.2f} decoded-GB/s ({len(blob) / bound_s / 1e9:.2f} GB/s "
          f"wire)", file=r.out, flush=True)
    from .kernels.decode import build_plan
    for label, make in (
            ("COLD first SUM (build_plan)", lambda: build_plan(col, dev)),
            ("COLD first SUM (plan snapshot restore)",
             lambda: plan_store.restore(blob, dev))):
        def first_sum():
            return engine.exact_sum_totals(make()).tolist()
        g = decoded / _wall(first_sum, dev) / 1e9
        r.add(label, "ALP", "1 card", g,
              note=f"({100 * g / bound:.2f}% of the upload bound)")


def companions(base: np.ndarray, dev) -> None:
    """The correctness companions on the source column: each answer on
    ``dev`` against numpy or ``math.fsum``; raises on any mismatch."""
    small = compress(base)

    def same(what, got, want):
        if not got == want:
            raise AssertionError(f"companion {what}: {got!r} != {want!r}")

    same("SUM", engine.query_sum(small, dev), math.fsum(base))
    same("MIN", engine.query_min(small, dev), base.min())
    same("MAX", engine.query_max(small, dev), base.max())
    same("TOP-K", engine.query_topk(small, 3, device=dev)[0], base.max())
    same("histogram",
         int(engine.query_histogram(small, [-40.0, 0.0, 45.0], dev).sum()),
         int(((base >= -40.0) & (base <= 45.0)).sum()))
    sk = np.arange(base.size) % 3
    gb = engine.query_groupby(small, sk, 3, aggs=("sum", "count"),
                              device=dev)
    for g in range(3):
        same(f"GROUP-BY sum {g}", float(gb["sum"][g]),
             math.fsum(base[sk == g].tolist()))
    same("MEDIAN", engine.query_median(small, dev), np.median(base))
    same("QUANTILE", engine.query_quantile(small, 0.9, device=dev),
         np.quantile(base, 0.9))
    plan = small.plan(dev)
    step, args = make_unfused_filter_step(plan, -15.0, 25.0)
    same("FILTER COUNT without pushdown",
         int(step.result(torch.zeros((), dtype=torch.int64, device=dev),
                         *args)),
         engine.query_filter_count(small, -15.0, 25.0, dev))


def _uncompressed_row(r, dev, n_vectors: int, alp_gbps: float) -> None:
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    vals = torch.empty((n_vectors, columns.VECTOR), dtype=torch.float64,
                       device=dev).uniform_(-1e6, 1e6, generator=g)
    bits = vals.view(torch.int64)
    vec = torch.arange(n_vectors, dtype=torch.int64, device=dev)
    unc = bits.numel() * 8 / loop_bench(_uncompressed_step(), (bits, vec),
                                        ITERS, device=dev) / 1e9
    r.add("SUM exact scan (K5 over raw doubles; loop step)",
          "Uncompressed (card memory)", "1 card", unc,
          round(alp_gbps / unc, 2))


def _pde_chunks(data: np.ndarray) -> tuple:
    streams, patches = [], []
    for off in range(0, len(data), CHUNK):
        sig, exp, pat = pde_codec.pde_encode(data[off:off + CHUNK])
        streams.append(native.pde_chunk_stream(sig, exp))
        patches.append((off, exp, pat))
    return streams, patches


def _competitor_decode_rows(r, data: np.ndarray, alp_gbps: float) -> None:
    cores = os.cpu_count()
    bits = data.view(np.uint64)
    scratch = np.zeros(len(data), np.uint64)          # pages touched once
    ns = np.array([min(CHUNK, len(data) - off)
                   for off in range(0, len(data), CHUNK)], np.int64)
    for name in CODECS:
        patches = []
        if name == "pde":
            streams, patches = _pde_chunks(data)
        else:
            streams = [native.competitor_encode(name,
                                                data[off:off + CHUNK])[0]
                       for off in range(0, len(data), CHUNK)]
        for threads in THREADS:
            def run():
                native.competitor_decode_chunked(name, streams, ns, scratch,
                                                 threads)
            run()
            dt = _best(run)
            out = scratch
            if patches:
                out = scratch.copy()
                vals = out.view(np.float64)
                for off, exp, pat in patches:
                    vals[off:off + len(exp)][exp == native.PDE_EXCEPTION] = \
                        pat
            if not np.array_equal(out, bits):
                raise AssertionError(f"{name} at {threads} threads: decoded "
                                     f"bits differ")
            g = data.nbytes / dt / 1e9
            r.add("SUM-scan decode", name, f"{threads} thr ({cores}-core "
                  f"host)", g, round(alp_gbps / g, 1))
    lib = zstd_codec._load()
    blobs = [zstd_codec._compress_chunk(lib, data[off:off + CHUNK].tobytes())
             for off in range(0, len(data), CHUNK)]
    sizes = [int(n) * 8 for n in ns]
    bufs = [ctypes.create_string_buffer(s) for s in sizes]

    def dec(i):
        if not zstd_codec.decompress_into(blobs[i], 0,
                                          ctypes.addressof(bufs[i]),
                                          sizes[i]):
            raise AssertionError(f"zstd chunk {i} does not decompress")

    for threads in THREADS:
        def run():
            if threads == 1:
                for i in range(len(blobs)):
                    dec(i)
            else:
                with concurrent.futures.ThreadPoolExecutor(threads) as ex:
                    list(ex.map(dec, range(len(blobs))))
        run()
        dt = _best(run)
        if b"".join(bytes(b) for b in bufs) != data.tobytes():
            raise AssertionError("zstd: decompressed bytes differ")
        g = data.nbytes / dt / 1e9
        r.add("DECOMPRESSION", f"zstd level3 (v{zstd_codec.zstd_version()})",
              f"{threads} thr ({cores}-core host)", g,
              round(alp_gbps / g, 1))


def _host_rows(r, data: np.ndarray, dev) -> float:
    """Host compress and decompress through the native engine, and the
    card's decompress wall, f64 and f32; returns the f64 host compress
    GB/s."""
    cores = os.cpu_count()
    host_gbps = 0.0
    for dtype, scheme in ((np.float64, "ALP host engine (OpenMP)"),
                          (np.float32, "ALP host engine f32")):
        x = data if dtype == np.float64 else data.astype(np.float32)
        compress(x)                                   # page-warm
        dt = _best(lambda: compress(x), 5)
        g = r.add("COMPRESSION", scheme, f"{cores} cores",
                  x.nbytes / dt / 1e9)
        host_gbps = host_gbps or g
        col = compress(x)
        ut = np.uint64 if dtype == np.float64 else np.uint32
        decompress_host(col)                          # page-warm
        dt = _best(lambda: decompress_host(col), 5)
        if not np.array_equal(decompress_host(col).view(ut), x.view(ut)):
            raise AssertionError(f"decompress_host of "
                                 f"{np.dtype(dtype).name} differs")
        r.add("DECOMPRESSION", scheme, f"{cores} cores", x.nbytes / dt / 1e9)
        got = decompress(col, dev).cpu().numpy()
        if not np.array_equal(got.view(ut), x.view(ut)):
            raise AssertionError(f"decompress of {np.dtype(dtype).name} "
                                 f"differs")
        r.add("DECOMPRESSION", f"ALP decompress {np.dtype(dtype).name} "
              f"(card wall: plan build, copies, kernels)", "1 card",
              x.nbytes / _wall(lambda: decompress(col, dev), dev) / 1e9)
    return host_gbps


def _device_compress_rows(r, base: np.ndarray, dev, n_vec: int) -> float:
    """The device compress as two loop steps on decoded decimals; returns
    their combined GB/s."""
    src = columns.tile_column(compress(base), n_vec)
    values = src.plan(dev).run()
    del src
    ccd = compress_device(values=values, n_values=values.numel())
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    k_max = 1
    step, args = make_device_compress_step(values, k_max)
    meta = step.result(zero, *args)
    pairs = np.stack([meta.fac.cpu().numpy(), meta.exp.cpu().numpy()])
    if not np.array_equal(pairs, np.stack([ccd.fac, ccd.exp])):
        k_max = 5                   # some rowgroup keeps more than one pair
        step, args = make_device_compress_step(values, k_max)
        meta = step.result(zero, *args)
    for field in ("fac", "exp", "bit_width", "base", "exc_count"):
        if not np.array_equal(getattr(meta, field).cpu().numpy(),
                              getattr(ccd, field).astype(np.int64)):
            raise AssertionError(f"device compress step: {field} differs "
                                 f"from compress_device's")
    pack, pack_args = make_pack_step(ccd, values)
    flat = pack.result(zero, *pack_args).cpu().numpy().view(np.uint64)
    if not np.array_equal(flat, np.concatenate(ccd.packed)):
        raise AssertionError("pack step: words differ from compress_device's")
    nbytes = values.numel() * 8
    dt_a = loop_bench(step, args, ITERS // 2, device=dev)
    dt_b = loop_bench(pack, pack_args, ITERS // 2, device=dev)
    wall = _wall(lambda: compress_device(values=values,
                                         n_values=values.numel()), dev)
    return r.add("COMPRESSION", f"ALP device e2e (plan+encode+pack loop "
                 f"steps, k_max={k_max}; card-resident)", "1 card",
                 nbytes / (dt_a + dt_b) / 1e9,
                 note=f"(plan+encode {nbytes / dt_a / 1e9:.2f}, pack "
                      f"{nbytes / dt_b / 1e9:.2f} GB/s; compress_device "
                      f"wall {wall:.4f} s = {nbytes / wall / 1e9:.2f} GB/s)")


def _competitor_compress_rows(r, data: np.ndarray, alp_comp: float) -> None:
    cores = os.cpu_count()
    unc = np.empty_like(data)
    np.copyto(unc, data)
    g = data.nbytes / _best(lambda: np.copyto(unc, data)) / 1e9
    r.add("COMPRESSION", "uncompressed (memcpy)", f"1 thr ({cores}-core "
          f"host)", g, round(alp_comp / g, 2))
    bits = data.view(np.uint64)
    for name in CODECS:
        flat, off, words, ns = native.competitor_encode_chunked(
            name, data, CHUNK, 8)
        streams = [flat[off[c]:off[c] + words[c]].copy()
                   for c in range(len(ns))]
        out = np.zeros(len(data), np.uint64)
        native.competitor_decode_chunked(name, streams, ns, out, 8)
        if name == "pde":        # patches are the caller's: the input's
            for c, s in enumerate(streams):
                n, at = int(ns[c]), c * CHUNK
                exp = s[(n + 1) // 2:].view(np.uint8)[:n]
                sel = exp == native.PDE_EXCEPTION
                out[at:at + n][sel] = bits[at:at + n][sel]
        if not np.array_equal(out, bits):
            raise AssertionError(f"{name}: chunked encode does not decode "
                                 f"back")
        for threads in THREADS:
            def run():
                native.competitor_encode_chunked(name, data, CHUNK, threads)
            run()
            g = data.nbytes / _best(run) / 1e9
            r.add("COMPRESSION", name, f"{threads} thr ({cores}-core host)",
                  g, round(alp_comp / g, 1))
    lib = zstd_codec._load()
    raws = [data[off:off + CHUNK].tobytes()
            for off in range(0, len(data), CHUNK)]

    def enc(i):
        zstd_codec._compress_chunk(lib, raws[i])

    for threads in THREADS:
        def run():
            if threads == 1:
                for i in range(len(raws)):
                    enc(i)
            else:
                with concurrent.futures.ThreadPoolExecutor(threads) as ex:
                    list(ex.map(enc, range(len(raws))))
        g = data.nbytes / _best(run) / 1e9
        r.add("COMPRESSION", f"zstd level3 (v{zstd_codec.zstd_version()})",
              f"{threads} thr ({cores}-core host)", g,
              round(alp_comp / g, 1))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_rows(r, col, dev, decoded: int) -> None:
    """The sharded decode at world 1 against the bare decode, both warm
    walls, in a process group of this process alone (NCCL on a card,
    gloo on the CPU) unless the caller has one."""
    import torch.distributed as dist
    from .parallel import make_mesh
    from .parallel.sharded import sharded_decode
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)
    try:
        mesh = make_mesh(device_type=dev.type)
        plan = col.plan(dev)
        bare = plan.run()
        got = sharded_decode(mesh, col)
        if not torch.equal(got.view(plan.bits_dtype),
                           bare.reshape(-1)[:col.n_values].view(
                               plan.bits_dtype)):
            raise AssertionError("sharded_decode differs from the bare "
                                 "decode")
        del bare, got
        world = mesh.size()
        r.add("DECODE", "ALP bare DecodePlan.run() (warm wall)", "1 card",
              decoded / _wall(plan.run, dev) / 1e9)
        r.add("DECODE", f"ALP sharded_decode ({dist.get_backend()} mesh of "
              f"{world}; warm wall)", f"{world} card", decoded / _wall(
                  lambda: sharded_decode(mesh, col), dev) / 1e9)
    finally:
        if own:
            dist.destroy_process_group()


def rows(dev, seed: int = 0, vectors: int = VECTORS,
         host_vectors: int | None = None, dc_vectors: int = DC_VECTORS,
         out=None) -> list:
    """Run every row on ``dev``; returns the (query, scheme, parallelism,
    gbps, alp_speedup) tuples, printed on ``out`` (standard output) as
    they come.  ``vectors`` sizes the card's column, ``host_vectors`` (as
    many by default) the host and competitor rows' values, ``dc_vectors``
    the device compress steps' values."""
    out = sys.stdout if out is None else out
    dev = torch.device(dev)
    host_vectors = vectors if host_vectors is None else host_vectors
    r = _Rows(out)
    base = source_column(seed)
    col = columns.tile_column(compress(base), vectors)
    plan = col.plan(dev)
    decoded = col.n_vectors * columns.VECTOR * 8
    alp_gbps = _loop_rows(r, col, plan, dev, decoded)
    _wall_rows(r, col, dev, decoded)
    _cold_rows(r, col, plan, dev, decoded)
    companions(base, dev)
    print("# companions: SUM, MIN, MAX, TOP-K, histogram, GROUP-BY, MEDIAN, "
          "QUANTILE and the no-pushdown filter equal their references",
          file=out, flush=True)
    _uncompressed_row(r, dev, vectors, alp_gbps)
    data = np.tile(base, -(-host_vectors * columns.VECTOR // len(base)))[
        :host_vectors * columns.VECTOR]
    _competitor_decode_rows(r, data, alp_gbps)
    _host_rows(r, data, dev)
    alp_comp = _device_compress_rows(r, base, dev, dc_vectors)
    _competitor_compress_rows(r, data, alp_comp)
    _mesh_rows(r, col, dev, decoded)
    return r.rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m alp_tpu_torch.bench_e2e",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="write DIR/e2e_queries.csv (and its .metadata)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(None)
    except RuntimeError as e:
        print(f"bench_e2e: {e}", file=sys.stderr)
        return 1
    from .bench import card_line
    from .reports import speed_report
    print(f"# {card_line()}", file=sys.stderr, flush=True)
    result = rows(dev, args.seed)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        speed_report(result, os.path.join(args.out, "e2e_queries.csv"),
                     header=HEADER, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
