"""Run one cell of alp_tpu_torch's benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell's
configuration, traffic mix, ops and metrics are found by the names in
``BENCHMARK.json`` (``harness/spec.py``).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks`` (each number compared, with its limit); the same numbers are
the last lines of standard error.

It exits nonzero and prints no result where the machine has no CUDA
card or fewer than the cell asks for, where ``alp_tpu_torch`` cannot be
imported, and where ``jax``, ``jaxlib``, ``flax`` or ``alp_tpu`` is
loaded in this process once the window has closed.

A cell whose ``chips`` is above 1 runs as that many ranks, one process a
card (``harness/ranks.py``): this process is rank 0 and spawns the others
as this script with hidden arguments; every rank enforces the forbidden
modules, only rank 0 prints the result, and the run exits nonzero with
no result when a rank fails or the deadline passes.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "alp_tpu")
# caches of the program's builds, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules(names) -> list:
    """The top-level names among ``names`` (module names) that are
    forbidden, each compared whole: ``alp_tpu_torch`` is not
    ``alp_tpu``."""
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    from harness import ranks
    ranks.add_arguments(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    for var, sub in CACHE_DIRS.items():
        os.environ.setdefault(var, str(ROOT / ".perfbench_cache" / sub))
    sys.path[:0] = [str(HERE), str(ROOT)]
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    from harness import cell, ranks, spec

    bench = spec.Bench(ROOT)
    wl = bench.workload(args.workload)
    import torch
    if args.device == "cuda" and (not torch.cuda.is_available() or
                                  torch.cuda.device_count() < wl.chips):
        print(f"perfbench: {args.workload} needs {wl.chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    try:
        import alp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program is not importable: {e}",
              file=sys.stderr)
        return 3
    if wl.chips == 1:
        result, lines = cell.run(bench, wl, args.seed, args.seconds,
                                 bool(args.trace), args.device, T_START)
    else:
        try:
            cell.rows_generator(bench, wl.config)
        except ValueError as e:
            print(f"perfbench: {args.workload}: {e}", file=sys.stderr)
            return 2

        def body(r):
            return cell.run_ranks(bench, wl, args.seed, args.seconds,
                                  bool(args.trace), r, T_START)

        got = ranks.run(args, str(HERE / "run.py"), argv, wl.chips, wl.config, body,
                        T_START)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    if wl.chips > 1:
        if got is None:          # a rank other than 0
            return 0
        result, lines = got
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
