"""A copy of the checkout with a fixture cell on several cards added as
data, for the tests of ``harness/ranks.py`` and for trying such a cell on
cards:

    python3 perfbench/tests/fixture_cell.py <dest> --world 4 \
        [--rows 600037902] [--fault raise|hang|kill|fail|disagree]

writes ``<dest>``: ``BENCHMARK.json`` with the fixture's configuration
(``fixture/configs/fixture_lineitem.json``: LINEITEM at SF 100, drawn by
rows) and cell (``fixture_lineitem.count``, the Q6 COUNT WHERE mix of
``fixture/traffic/fixture_count.json`` on ``--world`` cards, named in
every per-layer metric but ``rank_passes_per_query``), ``perfbench/``
without its tests and with the fixture's files, and a link to the
program.  It prints the cell's name; run the cell from ``<dest>``:
``python3 perfbench/run.py --workload fixture_lineitem.count ...``.
"""

import argparse
import json
import pathlib
import shutil
import sys

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
FIXTURE = HERE / "fixture"
CONFIG = "fixture_lineitem"
CELL = "fixture_lineitem.count"
UNREAD = ("rank_passes_per_query",)


def install(dest, world: int, rows: int | None = None, fault=None,
            generator: str | None = None) -> str:
    """Write the copy at ``dest`` (a new or empty directory); returns the
    cell's name.  ``fault`` is a kind of the fixture's planted faults;
    ``generator`` replaces the configuration's."""
    dest = pathlib.Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    if any(dest.iterdir()):
        raise FileExistsError(f"{dest} is not empty")
    shutil.copytree(BENCH, dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for kind in ("configs", "generators", "ops", "traffic"):
        for f in (FIXTURE / kind).iterdir():
            shutil.copy(f, dest / "perfbench" / kind / f.name)
    path = dest / "perfbench" / "configs" / f"{CONFIG}.json"
    config = json.loads(path.read_text())
    if rows is not None:
        config["rows"] = int(rows)
    if generator is not None:
        config["generator"] = generator
    config["fault"] = None if fault is None else {"kind": fault}
    path.write_text(json.dumps(config, indent=2))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["configs"].append({
        "name": CONFIG, "source": config["source"],
        "file": f"perfbench/configs/{CONFIG}.json", "reduced": [],
        "why": "LINEITEM drawn by rows, for a cell on several cards"})
    data["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "fixture_count",
        "chips": int(world),
        "why": "Q6's COUNT WHERE on every rank's share, joined by an "
               "all-reduce"})
    for m in data["per_layer"]:
        if "workloads" in m and m["name"] not in UNREAD:
            m["workloads"].append(CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(data, indent=1))
    (dest / "alp_tpu_torch").symlink_to(ROOT / "alp_tpu_torch",
                                        target_is_directory=True)
    return CELL


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("dest")
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--fault", default=None,
                   choices=("raise", "hang", "kill", "fail", "disagree"))
    args = p.parse_args(argv)
    print(install(args.dest, args.world, args.rows, args.fault))
    return 0


if __name__ == "__main__":
    sys.exit(main())
