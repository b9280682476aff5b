"""Headline benchmark of the port: decode throughput of f64 columns on the card.

    python -m alp_tpu_torch.bench

Counterpart of the repository's ``bench.py``.  Its last line of standard
output is one JSON object,

    {"metric": "falp_decode_f64_suite_avg", "value": N, "unit": "GB/s",
     "vs_baseline": N / 56.0}

the mean over the five ``columns.BENCH_PROFILES`` (bit widths ~11, 20, 30,
42 and 0, after the reference's sample datasets, which the repository does
not ship) of decoded bytes per second of one column of ``TARGET_VECTORS``
vectors (32,768: 256 MiB of doubles).  Each profile is generated from
seed 0 over ``SOURCE_ROWGROUPS`` rowgroups (10), compressed on the host,
tiled to ``TARGET_VECTORS`` vectors (``columns.tile_column``) and planned
once; the timed work is what ``DecodePlan.run()`` launches on the card,
the exception patch included, timed with CUDA events by
``benchlib.loop_bench`` (best of 2 passes of ``ITERS`` iterations, the
carry in every bucket's metadata).  The baseline,
56 GB/s, is the reference's CPU speed of light for decoded doubles on one
core (``BASELINE.md`` §3).  On standard error, before it: the card's name
and power limit, each profile's GB/s beside the kernels alone (the same
launches without the patch) and the ``decompress`` wall (plan build,
copies and kernels), the geometric mean and the least profile.

Without a card it exits nonzero.  It writes no file.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import benchlib, columns
from .container import compress, decompress
from .engine import LoopStep, carried
from .kernels import decode

BASELINE_GBPS = 56.0
TARGET_VECTORS = 32 * 1024             # 256 MiB of doubles a profile
SOURCE_ROWGROUPS = 10
ITERS = 40


def profile_columns(seed: int = 0, rowgroups: int = SOURCE_ROWGROUPS,
                    vectors: int = TARGET_VECTORS) -> dict:
    """name -> the compressed bench profile, tiled to ``vectors``."""
    rng = np.random.default_rng(seed)
    data = columns.route_columns(rng, rowgroups * columns.RG_VECTORS)
    return {name: columns.tile_column(compress(data[name]), vectors)
            for name in columns.BENCH_PROFILES}


def make_decode_step(plan, patch: bool = True):
    """The headline's step: the plan's decode (``DecodePlan.run()``, or
    with ``patch=False`` its kernel launches alone) with the carry in every
    bucket's metadata, the carry ADDed to the first value's bits (an XOR
    chain would cancel on a bit-width-0 bucket, ``bench.py:86-95``)."""
    vdt = torch.float64 if plan.f64 else torch.float32

    def result(carry, plan):
        view = carried(plan, carry)
        if patch:
            return view.run()
        out = torch.empty((plan.n_vectors, decode.VECTOR_SIZE), dtype=vdt,
                          device=plan.device)
        for bucket in view.buckets:
            view.launch(bucket, out)
        return out

    def fold(out, carry):
        return carry + out.view(plan.bits_dtype)[0, 0].to(torch.int64)

    return LoopStep(result, fold), (plan,)


def bench_column(col, device=None) -> dict:
    """{"gbps", "kernels_gbps", "decompress_s", "launches"} of one column:
    decoded bytes per second of the full decode and of its kernels alone,
    the wall of one ``decompress`` (host clock, synchronised) and the
    kernel launches of one decode."""
    dev = decode.resolve_device(device)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    decompress(col, dev)
    if on_card:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    plan = decode.build_plan(col, dev)
    decoded = plan.n_vectors * decode.VECTOR_SIZE * plan.bits_dtype.itemsize
    full = benchlib.loop_bench(*make_decode_step(plan), ITERS, device=dev)
    alone = benchlib.loop_bench(*make_decode_step(plan, patch=False), ITERS,
                                device=dev)
    return {"gbps": decoded / full / 1e9, "kernels_gbps": decoded / alone / 1e9,
            "decompress_s": wall, "launches": len(plan.buckets)}


def headline(results: dict) -> dict:
    """The last line: the arithmetic mean over the profiles."""
    avg = float(np.mean([r["gbps"] for r in results.values()]))
    return {"metric": "falp_decode_f64_suite_avg", "value": avg,
            "unit": "GB/s", "vs_baseline": avg / BASELINE_GBPS}


def report(results: dict, out=None) -> None:
    """Each profile, the geometric mean and the least profile (on standard
    error unless ``out`` is given)."""
    out = sys.stderr if out is None else out
    for name, r in results.items():
        print(f"# {name}: {r['gbps']:.1f} GB/s decode with the patch, "
              f"{r['kernels_gbps']:.1f} GB/s kernels alone, "
              f"{r['launches']} launches, decompress wall "
              f"{r['decompress_s']:.4f} s", file=out)
    rates = [r["gbps"] for r in results.values()]
    geo = float(np.exp(np.mean(np.log(rates))))
    print(f"# geomean: {geo:.1f} GB/s ({geo / BASELINE_GBPS:.2f}x the "
          f"baseline); min column: {min(rates):.1f} GB/s "
          f"({min(rates) / BASELINE_GBPS:.2f}x)", file=out)


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    try:
        dev = decode.resolve_device(None)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    print(f"# {card_line()}", file=sys.stderr)
    results = {name: bench_column(col, dev)
               for name, col in profile_columns().items()}
    report(results)
    print(json.dumps(headline(results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
