"""The SF-1000 cell on several cards, on the CPU: its traffic, generator and
metrics.

* ``lineitem_sf1000.sharded_agg`` through ``perfbench/run.py`` over gloo
  (``--device cpu``) at worlds 2 and 4, in a copy of the checkout whose
  ``tpch_lineitem_sf1000`` is cut to five rowgroups and whose cell takes
  the world's cards: every answer checked, every number 0;
* ``generators/tpch_lineitem_rows.py``: the same rows under every split,
  across its blocks, by the clause's formulas;
* ``collective_ms_per_query``, ``shard_roofline_pct`` and
  ``shard_idle_pct`` on a synthetic trace with NCCL kernels, which the
  last two leave out and ``roofline_pct`` and ``device_idle_pct`` do not.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import types

import pytest
import torch

from harness import spec, trace, traffic

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CELL = "lineitem_sf1000.sharded_agg"
CONFIG = "tpch_lineitem_sf1000"
ROWS = 4 * 102400 + 77          # five rowgroups: one or two a rank
SEED = 2**31 + 4321
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


def _install(dest: pathlib.Path, world: int, rows: int = ROWS) -> None:
    """A copy of the checkout at ``dest``: ``perfbench/`` without its tests,
    the configuration cut to ``rows``, the cell on ``world`` cards, and a
    link to the program."""
    shutil.copytree(BENCH, dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = dest / "perfbench" / "configs" / f"{CONFIG}.json"
    config = json.loads(path.read_text())
    config["rows"] = rows
    path.write_text(json.dumps(config, indent=2))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in data["workloads"]:
        if cell["name"] == CELL:
            cell["chips"] = world
    (dest / "BENCHMARK.json").write_text(json.dumps(data, indent=1))
    (dest / "alp_tpu_torch").symlink_to(ROOT / "alp_tpu_torch",
                                        target_is_directory=True)


@pytest.mark.parametrize("world,traced", [(2, 0), (4, 0), (2, 1)])
def test_sharded_agg_runs_correct_over_gloo(tmp_path, world, traced):
    _install(tmp_path, world)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "0.3", "--trace", str(traced), "--device",
         "cpu", "--deadline", "240"], capture_output=True, text=True,
        timeout=300, cwd=tmp_path, env=ENV)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-4000:]
    mix = json.loads((BENCH / "traffic" / "sharded_agg.json").read_text())
    assert result["failed"] == 0
    assert result["attempted"] >= 3 * traffic.cycle_length(mix)
    checks = result["checks"]
    assert set(checks) == {"unanswered", "unchecked", "ulp_gap",
                           "count_gap", "ranks_disagree"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in checks.values())
    assert result["device"]["count"] == world
    if traced:
        assert result["metrics"]["collective_ms_per_query"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"scan_gb_per_s", "query_p95_ms",
                                          "setup_s"}


def _generator():
    return spec.Bench(ROOT).generator("tpch_lineitem_rows")


def _seed_of(name):
    return traffic.subseed(SEED, "data", name)


SPLITS = [(0, 1 << 20, (1 << 20) + 5000),            # at the block's edge
          (0, 7, 102400, 204800, (1 << 20) + 5000),
          (0, 999_999, 1_000_001, (1 << 20) + 5000)]


@pytest.mark.parametrize("name", ["l_quantity", "l_extendedprice",
                                  "l_discount", "l_tax"])
def test_rows_are_the_same_under_every_split(name):
    gen = _generator()
    config = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    n = SPLITS[0][-1]
    whole = gen.column(name, config, n, _seed_of, "cpu")
    assert whole.dtype == torch.float64 and whole.shape == (n,)
    for cuts in SPLITS:
        parts = [gen.rows(name, config, lo, hi, _seed_of, "cpu")
                 for lo, hi in zip(cuts, cuts[1:])]
        assert torch.equal(torch.cat(parts), whole), cuts
    cents = torch.round(whole * 100).to(torch.int64)
    assert torch.equal(cents.double() / 100, whole)
    lo, hi = {"l_quantity": (100, 5000), "l_discount": (0, 10),
              "l_tax": (0, 8), "l_extendedprice": (90000, 10495000)}[name]
    assert int(cents.min()) >= lo and int(cents.max()) <= hi
    if name == "l_extendedprice":
        qty = gen.column("l_quantity", config, n, _seed_of, "cpu")
        assert bool((cents % qty.to(torch.int64) == 0).all())


def _trace() -> trace.Trace:
    """Two requests; in each a decode kernel and an NCCL kernel that spins
    for the slowest rank; collective spans in both."""
    events = []

    def x(cat, name, ts, dur, corr=None):
        events.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                       "dur": dur, "args": {"correlation": corr}})

    x("user_annotation", "request.sum@l_quantity", 0, 100)
    x("user_annotation", "alp.parallel.sum", 2, 96)
    x("user_annotation", "alp.parallel.all_gather", 20, 10)
    x("user_annotation", "alp.parallel.all_gather", 25, 10)
    x("user_annotation", "request.q6_discount@l_discount", 200, 100)
    x("user_annotation", "alp.parallel.all_reduce", 250, 10)
    for corr, (ts, name, start, dur) in enumerate(
            [(5, "falp_decode_f64_exact_sum", 10, 30),
             (8, "ncclDevKernel_AllGather_RING_LL(ncclDevComm*)", 40, 50),
             (205, "key_counts", 210, 20),
             (206, "ncclKernel_AllReduce_RING_LL_Sum_int64_t", 230, 60)]):
        x("cuda_runtime", "cudaLaunchKernel", ts, 1, corr)
        x("kernel", name, start, dur, corr)
    return trace.from_events(events)


def test_shard_metrics_leave_the_collectives_kernels_out():
    tr = _trace()
    run = types.SimpleNamespace(trace=tr, least_s=[15e-6, 10e-6],
                                window=types.SimpleNamespace(
                                    records=[object(), object()]))
    bench = spec.Bench(ROOT)

    def read(name):
        return bench.metric(name).read(run)

    # busy: 80 us a request with NCCL's kernels, 30 and 20 without
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 160 / 300))
    assert read("shard_idle_pct") == pytest.approx(100 * (1 - 50 / 300))
    assert read("roofline_pct") == pytest.approx(100 * 25 / 160)
    assert read("shard_roofline_pct") == pytest.approx(100 * 25 / 50)
    # the union of each request's collective spans: 15 and 10 us
    assert read("collective_ms_per_query") == pytest.approx(12.5e-3)


def test_shard_metrics_read_nothing_without_a_trace_or_collectives():
    empty = types.SimpleNamespace(trace=None, least_s=[], window=None)
    bench = spec.Bench(ROOT)
    for name in ("collective_ms_per_query", "shard_roofline_pct",
                 "shard_idle_pct"):
        assert bench.metric(name).read(empty) is None
    bare = trace.from_events([{"ph": "X", "cat": "user_annotation",
                               "name": "request.sum@l_tax", "ts": 0,
                               "dur": 10}])
    run = types.SimpleNamespace(trace=bare, least_s=[None],
                                window=types.SimpleNamespace(records=[1]))
    for name in ("collective_ms_per_query", "shard_roofline_pct",
                 "shard_idle_pct"):
        assert bench.metric(name).read(run) is None
