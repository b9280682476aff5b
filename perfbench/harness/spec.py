"""The benchmark's declaration and the files it names.

``BENCHMARK.json`` at the root of the checkout lists configurations,
cells (``workloads``) and metrics.  Everything that belongs to one name
sits in a file of its own, found by that name under ``perfbench/``:

* a configuration: the JSON file its entry names (``configs/<name>.json``),
  whose ``generator`` names ``generators/<generator>.py``;
* a traffic mix: ``traffic/<traffic>.json``, whose templates name ops;
* an op (one kind of request): ``ops/<op>.py``;
* a per-layer metric: ``metrics/<name>.py``.

A cell is added by adding such files and entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    config: dict          # the configuration's file, as run
    traffic: dict         # the traffic mix's file
    chips: int
    end_to_end: list      # entries of BENCHMARK.json's end_to_end it reports
    per_layer: list       # entries of per_layer it reports


class Bench:
    """``BENCHMARK.json`` of a checkout, and the files of its names."""

    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.dir = self.root / "perfbench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            for entry in self.data[group]:
                if not NAME.match(entry["name"]):
                    raise ValueError(f"bad {group} name {entry['name']!r}")

    def workload(self, name: str) -> Workload:
        cells = {w["name"]: w for w in self.data["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        cell = cells[name]
        configs = {c["name"]: c for c in self.data["configs"]}
        config = json.loads((self.root / configs[cell["config"]]["file"])
                            .read_text())

        def mine(metric):
            return "workloads" not in metric or name in metric["workloads"]

        return Workload(
            name=name, config=config, traffic=self.traffic(cell["traffic"]),
            chips=int(cell["chips"]),
            end_to_end=[m for m in self.data["end_to_end"] if mine(m)],
            per_layer=[m for m in self.data["per_layer"] if mine(m)])

    def traffic(self, name: str) -> dict:
        return json.loads(self._file("traffic", name, ".json").read_text())

    def op(self, name: str):
        return self._module("ops", name)

    def generator(self, name: str):
        return self._module("generators", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def _file(self, kind: str, name: str, suffix: str) -> pathlib.Path:
        if not NAME.match(name):
            raise ValueError(f"bad {kind} name {name!r}")
        path = self.dir / kind / f"{name}{suffix}"
        if not path.is_file():
            raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
        return path

    def _module(self, kind: str, name: str):
        path = self._file(kind, name, ".py")
        key = f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}"
        mod = sys.modules.get(key)
        if mod is None or pathlib.Path(mod.__file__) != path:
            spec = importlib.util.spec_from_file_location(key, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[key] = mod
            spec.loader.exec_module(mod)
        return mod
