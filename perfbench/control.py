"""Run the check's control of a cell on some seeds and print its numbers.

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...]
                                 [--device cuda] [--deadline <s>]

The control (``harness/control.py``) answers the cell's requests from
its values rounded to float32, by the plain reference, at the cell's own
size; the check holds them against the float64 reference.  One JSON line
a seed: each number with its limit, and whether the control passed (it
must not).  The benchmark's runs never run it.  A cell on several cards
runs as its ranks (``harness/ranks.py``), every seed in one process a
rank, under one deadline (``--deadline``, seconds).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _line(workload, seed, numbers, checked) -> str:
    from harness import check
    return json.dumps({"workload": workload, "seed": seed,
                       "checked": checked,
                       "control_passed": check.passed(numbers),
                       "numbers": {n: {"value": v, "limit": lim}
                                   for n, (v, lim) in numbers.items()}})


def main(argv=None) -> int:
    sys.path[:0] = [str(HERE), str(ROOT)]
    argv = sys.argv[1:] if argv is None else list(argv)
    from harness import control, ranks, spec
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    ranks.add_arguments(p)
    args = p.parse_args(argv)
    import torch

    bench = spec.Bench(ROOT)
    wl = bench.workload(args.workload)
    if wl.chips == 1:
        for seed in args.seeds:
            numbers, checked = control.run(bench, wl, seed,
                                           torch.device(args.device))
            print(_line(args.workload, seed, numbers, checked), flush=True)
        return 0

    def body(r):
        for seed in args.seeds:
            got = control.run_ranks(bench, wl, seed, r)
            if got is not None:
                print(_line(args.workload, seed, *got), flush=True)

    ranks.run(args, str(HERE / "control.py"), argv, wl.chips, wl.config,
              body, T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
