#!/usr/bin/env python3
"""Drive alp_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each printing its wall time:

1. env      the card's name and power limit (nvidia-smi).
2. build    the CUDA kernels (one nvcc call, sm_90a) and the host engine
            (g++ over native/alpcore.cpp), cold or cached.
3. compress columns generated from the seed, one per decode route: the
            five profiles of bench.py (bit widths ~0/11/20/30/42), an ALP
            column reaching bit widths 53-64, f64 ALP_RD, f32 ALP, f32
            ALP_RD, a mixed ALP/ALP_RD column, and one with NaN, +-Inf and
            -0.0 exceptions and a tail.  Each is compressed on the host
            over >= 10 rowgroups and carried through its ALPT bytes; the
            bench profiles are then tiled to 32,768 vectors (256 MiB of
            doubles) as bench.py does, and the f64 ALP_RD and both f32
            columns to 256 MiB of decoded values.
4. decode   ``alp_tpu_torch.decompress(col)`` on the card for every column
            (the main path: launch counts are set to 0 just before and
            read just after); the output's bits must equal the input's.
5. kernels  each kernel against its plain PyTorch version on the card, on
            the same plans, bit for bit (tolerance 0: the codec is
            lossless).
6. timing   CUDA-event time of each kernel at the 256 MiB shapes, beside
            its bound (the bytes it must move at 3.35 TB/s, or its
            operations at 67 TFLOP/s, whichever is larger), the plain
            version's time and a device-to-device ``copy_`` of the decoded
            bytes as a yardstick.

Then the nvidia-smi line, one JSON line with every kernel's numbers and,
last, ``{"ok": true, "device": {...}}``.  Any failure exits nonzero before
that line.  Without a CUDA device, or without the package beside this
file, it exits nonzero at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FLOPS_PER_S = 67e12              # H100 non-tensor float32 peak
VECTOR = 1024
ROWGROUP_VECTORS = 100
SOURCE_VECTORS = 10 * ROWGROUP_VECTORS
BENCH_VECTORS = 32 * 1024        # bench.py's TARGET_VECTORS: 256 MiB of f64
# columns tiled to 256 MiB of decoded values before they are decoded
TILE_TO = {"f64_alp_rd": BENCH_VECTORS, "f32_alp": 2 * BENCH_VECTORS,
           "f32_alp_rd": 2 * BENCH_VECTORS}
KERNELS = {
    "falp_decode_f64": ("alp_tpu/kernels/falp.py:143", [
        "alp_tpu/kernels/falp.py:230", "alp_tpu/kernels/falp.py:322",
        "alp_tpu/kernels/falp.py:394", "alp_tpu/kernels/falp.py:444",
        "alp_tpu/kernels/falp.py:1229"]),
    "falp_decode_f32": ("alp_tpu/kernels/falp.py:1336", []),
    "rd_decode_dict_f64": ("alp_tpu/kernels/falp.py:1470", []),
    "rd_decode_dict_f32": ("alp_tpu/kernels/falp.py:1530", []),
}


def phase(name: str, t0: float, detail: str = "") -> None:
    print(f"[{name}] {time.perf_counter() - t0:.3f} s {detail}".rstrip(),
          flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def kernel_of(plan, bucket) -> str:
    kind = "falp_decode" if bucket.scheme == 2 else "rd_decode_dict"
    return f"{kind}_{'f64' if plan.f64 else 'f32'}"


def bits_view(t):
    import torch
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def run_plain(plan, bucket, out) -> None:
    """The bucket through its kernel's plain PyTorch version."""
    from alp_tpu_torch.kernels import falp
    if bucket.scheme == 2:
        vals = falp.falp_plain(bucket.args[0], bucket.bw, *bucket.args[1:])
        out[bucket.rows] = vals
    else:
        right, left, dictionary, dict_size = bucket.args
        bits_view(out)[bucket.rows] = falp.rd_plain(
            right, bucket.bw, left, bucket.lbw, dictionary, dict_size)


def bucket_bytes(bucket, value_size: int) -> int:
    """Bytes the decode of a bucket must move: every input read once
    (packed words, metadata, output rows), every value written once."""
    read = sum(t.numel() * t.element_size() for t in bucket.args)
    read += bucket.rows.numel() * bucket.rows.element_size()
    return read + bucket.n_vectors * VECTOR * value_size


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    import torch
    if torch.equal(bits_view(a), bits_view(b)):
        return 0.0
    diff = (a.double() - b.double()).abs()
    return float(diff.nan_to_num(nan=float("inf")).max())


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_all = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import alp_tpu_torch
        from alp_tpu_torch import native
        from alp_tpu_torch.columns import (BENCH_PROFILES, route_columns,
                                           tile_column)
        from alp_tpu_torch.kernels import _build, decode, falp
    except ImportError as e:
        print(f"chip_smoke: alp_tpu_torch is not importable: {e}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # 1. env
    t0 = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    phase("env", t0, f"device={kind!r} nvidia-smi={smi!r} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    _build.lib()
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    t1 = time.perf_counter()
    _, gxx_s = native.build()
    native.lib()
    phase("build", t0, f"nvcc={built['seconds']:.3f}s "
          f"({'cold' if built['seconds'] else 'cached'}) "
          f"g++={gxx_s:.3f}s "
          f"({'cold' if gxx_s else 'cached'}) "
          f"load={time.perf_counter() - t1 - gxx_s:.3f}s")

    # 3. compress
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    columns = {}
    tile_to = dict(TILE_TO, **{name: BENCH_VECTORS for name in BENCH_PROFILES})
    for name, x in route_columns(rng, SOURCE_VECTORS).items():
        target = tile_to.get(name)
        tc = time.perf_counter()
        col = alp_tpu_torch.compress(x)
        blob = col.to_bytes()
        col = alp_tpu_torch.CompressedColumn.from_bytes(blob)
        if col.to_bytes() != blob:
            raise RuntimeError(f"{name}: ALPT bytes do not re-serialise")
        schemes = sorted({"ALP" if s == 2 else "ALP_RD"
                          for s in col.rg_scheme.tolist()})
        alp = col.rg_scheme[np.arange(col.n_vectors) // ROWGROUP_VECTORS] == 2
        bws = sorted(set(col.bit_width[alp].tolist()))
        note = ""
        if name == "f64_alp_bw53_64" and not any(b >= 53 for b in bws):
            note = (" NOTE: the planner gave this column no ALP vector "
                    "of bit width 53-64")
        print(f"  {name}: n={len(x)} rowgroups={col.n_rowgroups} "
              f"schemes={schemes} alp_bit_widths={bws} "
              f"exceptions={int(col.exc_count.sum())} "
              f"bits/value={col.bits_per_value():.3f} "
              f"compress={time.perf_counter() - tc:.3f}s{note}", flush=True)
        expected = x
        if target:
            col = tile_column(col, target)
            reps = -(-target * VECTOR // len(x))
            expected = np.tile(x, reps)[:target * VECTOR]
        columns[name] = (col, expected)
    phase("compress", t0, f"{len(columns)} columns")

    # 4. decode: the main path, through the public entry point
    t0 = time.perf_counter()
    expected_dev = {
        name: torch.from_numpy(exp.view(f"i{exp.dtype.itemsize}")).to(dev)
        for name, (_, exp) in columns.items()}
    torch.cuda.synchronize()
    falp.reset_launches()
    td = time.perf_counter()
    for name, (col, _) in columns.items():
        before = dict(falp.LAUNCHES)
        tw = time.perf_counter()
        out = alp_tpu_torch.decompress(col)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
        if out.shape != (col.n_values,) or out.device.type != "cuda":
            raise RuntimeError(f"{name}: decoded shape {tuple(out.shape)} "
                               f"on {out.device}")
        if not torch.equal(bits_view(out), expected_dev[name]):
            bad = int((bits_view(out) != expected_dev[name]).sum())
            raise RuntimeError(f"{name}: {bad} decoded values differ "
                               f"from the input bits")
        moved = {k: v - before[k] for k, v in falp.LAUNCHES.items()
                 if v != before[k]}
        if not moved:
            raise RuntimeError(f"{name}: no kernel launched")
        print(f"  {name}: {col.n_values} values bit-exact, "
              f"launches={moved}, decompress wall {wall:.4f} s "
              f"(host plan + copies + kernels)", flush=True)
    main_launches = dict(falp.LAUNCHES)
    decode_s = time.perf_counter() - td
    for k, v in main_launches.items():
        if v == 0:
            raise RuntimeError(f"kernel {k} was not launched on the main path")
    del expected_dev
    phase("decode", t0, f"main path {decode_s:.3f}s launches={main_launches}")

    # 5. kernels vs plain versions, on the card, same plans
    t0 = time.perf_counter()
    errors = {k: 0.0 for k in KERNELS}
    plans = {}
    for name, (col, _) in columns.items():
        plan = decode.build_plan(col, dev)
        plans[name] = plan
        vdt = torch.float64 if plan.f64 else torch.float32
        for bucket in plan.buckets:
            a = torch.zeros((col.n_vectors, VECTOR), dtype=vdt, device=dev)
            b = torch.zeros_like(a)
            plan.launch(bucket, a)
            run_plain(plan, bucket, b)
            torch.cuda.synchronize()
            err = max_abs_err(a, b)
            k = kernel_of(plan, bucket)
            errors[k] = max(errors[k], err)
            if err != 0.0 or not torch.equal(bits_view(a), bits_view(b)):
                raise RuntimeError(
                    f"{name}: {k} bucket bw={bucket.bw} lbw={bucket.lbw} "
                    f"differs from its plain version (max abs err {err})")
    phase("kernels", t0, "every bucket of every column: kernel bits == "
          "plain bits (tolerance 0)")

    # 6. timing at the 256 MiB shapes
    t0 = time.perf_counter()
    timed = {"falp_decode_f64": list(BENCH_PROFILES),
             "falp_decode_f32": ["f32_alp"],
             "rd_decode_dict_f64": ["f64_alp_rd"],
             "rd_decode_dict_f32": ["f32_alp_rd"]}
    rows = []
    for k, names in timed.items():
        ms, plain_ms, bound_ms, copy_ms, by = [], [], [], [], "bytes"
        decoded_gbs = []
        for name in names:
            plan = plans[name]
            col = columns[name][0]
            vdt = torch.float64 if plan.f64 else torch.float32
            out = torch.empty((col.n_vectors, VECTOR), dtype=vdt, device=dev)
            mine = [b for b in plan.buckets if kernel_of(plan, b) == k]
            t_k = cuda_ms(lambda: [plan.launch(b, out) for b in mine], 20)
            t_p = cuda_ms(lambda: [run_plain(plan, b, out) for b in mine], 3)
            src = out.clone()
            dst = torch.empty_like(out)
            t_c = cuda_ms(lambda: dst.copy_(src), 20)
            nbytes = sum(bucket_bytes(b, out.element_size()) for b in mine)
            n_vals = sum(b.n_vectors for b in mine) * VECTOR
            # falp: one int->float conversion and one multiply per value
            ops = 2 * n_vals if k.startswith("falp") else 0
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = ops / FLOPS_PER_S * 1e3
            by = "bytes" if b_bytes >= b_ops else "operations"
            ms.append(t_k)
            plain_ms.append(t_p)
            bound_ms.append(max(b_bytes, b_ops))
            copy_ms.append(t_c)
            print(f"  {k} on {name}: {len(mine)} launches/decode, "
                  f"{nbytes} bytes, kernel {t_k:.4f} ms, plain {t_p:.4f} ms,"
                  f" bound {max(b_bytes, b_ops):.4f} ms ({by}), "
                  f"copy_ {t_c:.4f} ms, moved {nbytes / t_k / 1e6:.1f} GB/s, "
                  f"decoded {n_vals * out.element_size() / t_k / 1e6:.1f} "
                  f"GB/s", flush=True)
            decoded_gbs.append(n_vals * out.element_size() / t_k / 1e6)
            del out, src, dst
        print(f"  {k}: mean decoded GB/s over {names}: "
              f"{float(np.mean(decoded_gbs)):.1f}", flush=True)
        rows.append({
            "name": k, "route": "cuda", "source": "alp_tpu_torch/csrc/falp.cu",
            "replaces": KERNELS[k][0], "also_replaces": KERNELS[k][1],
            "launches": main_launches[k], "max_abs_err": errors[k],
            "ms": float(np.mean(ms)), "plain_ms": float(np.mean(plain_ms)),
            "bound_ms": float(np.mean(bound_ms)), "bound_by": by,
            "library_ms": float(np.mean(copy_ms)),
            "library_call": "Tensor.copy_ of the decoded bytes (a yardstick;"
                            " no PyTorch call decodes ALP)",
            "timed_on": names,
        })
    phase("timing", t0)
    phase("total", t_all)

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
