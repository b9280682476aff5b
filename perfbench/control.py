"""Run the check's control of a cell on some seeds and print its numbers.

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...]
                                 [--device cuda]

The control (``harness/control.py``) answers the cell's requests from
its values rounded to float32, by the plain reference, at the cell's own
size; the check holds them against the float64 reference.  One JSON line
a seed: each number with its limit, and whether the control passed (it
must not).  The benchmark's runs never run it.
"""

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    from harness import check, control, spec
    wl = spec.Bench(ROOT).workload(args.workload)
    for seed in args.seeds:
        numbers, checked = control.run(spec.Bench(ROOT), wl, seed,
                                       torch.device(args.device))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checked": checked,
                          "control_passed": check.passed(numbers),
                          "numbers": {n: {"value": v, "limit": lim}
                                      for n, (v, lim) in numbers.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
