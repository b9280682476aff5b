"""A cell on several cards: its ranks, shares, lockstep, check and control.

Each test installs the fixture cell (``fixture_cell.py``: LINEITEM drawn
by rows, Q6's COUNT WHERE counted on every share and joined by an
all-reduce) into a copy of the checkout, and runs ``perfbench/run.py`` or
``perfbench/control.py`` from it on the CPU (``--device cpu``: gloo for the
mesh and the harness alike), as the benchmark's command runs on cards.
"""

import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import alp_tpu_torch
from harness import ranks, roofline, spec, traffic, window
import fixture_cell

ROWS = 4 * 102400 + 77          # five rowgroups: one a rank at W = 4
SEED = 2**31 + 1234
ONE_CARD_KEYS = {"setup_s", "scan_gb_per_s", "query_p95_ms"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
ENV = {**os.environ, "OMP_NUM_THREADS": "2"}


def _install(tmp_path, world, **kw):
    return tmp_path / "checkout", fixture_cell.install(
        tmp_path / "checkout", world, kw.pop("rows", ROWS), **kw)


def _run(root, cell, *extra, seconds=0.3, trace=0, deadline=240,
         script="run.py", timeout=300):
    args = (["--workload", cell, "--seed", str(SEED), "--seconds",
             str(seconds), "--trace", str(trace)] if script == "run.py"
            else ["--workload", cell])
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, f"perfbench/{script}", *args, *extra, "--device",
         "cpu", "--deadline", str(deadline)], capture_output=True,
        text=True, timeout=timeout, cwd=root, env=ENV)
    return out, time.monotonic() - t0


def _spawned(stderr: str) -> list:
    return [int(p) for p in re.findall(r"perfbench: rank \d+ pid (\d+)",
                                       stderr)]


def _alive(pid: int) -> bool:
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def _result(out) -> dict:
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("world,trace", [(1, 0), (2, 0), (4, 0), (2, 1)])
def test_a_fixture_cell_runs_correct_on_every_world(tmp_path, world, trace):
    root, cell = _install(tmp_path, world)
    out, _ = _run(root, cell, trace=trace)
    assert out.returncode == 0, out.stderr[-4000:]
    result = _result(out)
    assert result["correct"], out.stderr[-4000:]
    assert result["failed"] == 0 and result["attempted"] >= 6
    keys = RESULT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    dev = result["device"]
    assert dev["platform"] == "cpu" and dev["count"] == world
    if not trace:
        assert set(result["metrics"]) == ONE_CARD_KEYS
    pids = _spawned(out.stderr)
    assert len(pids) == world - 1
    assert not any(_alive(p) for p in pids)
    if world == 1:          # today's path: no rank, no group, no step
        assert "ranks" not in dev and "ranks_disagree" not in \
            result["checks"]
        assert "bench.ranks.step" not in out.stderr
        return
    assert [sorted(r) for r in dev["ranks"]] == [sorted(dev["ranks"][0])] \
        * world
    assert result["checks"]["ranks_disagree"] == {"value": 0, "limit": 0}
    steps = re.search(r"ranks: (\d+) requests in lockstep", out.stderr)
    assert steps and int(steps.group(1)) == result["attempted"]
    assert all(f"rank {r}: rows [" in out.stderr for r in range(1, world))
    if trace:
        assert set(dev["ranks"][0]) >= {"busy_s", "window_s"}
        assert dev["window_s"] == dev["ranks"][0]["window_s"]
        got = re.search(r"trace: (\d+) bench.ranks.step spans", out.stderr)
        assert got and int(got.group(1)) == 2 * result["attempted"]


def test_the_lockstep_loop_ends_on_rank_0s_word():
    mix = spec.Bench(fixture_cell.ROOT).traffic("scan")
    posted = []

    def call(req, span):
        return req.index, {}

    def decide(go):             # rank 0's own word
        posted.append(go)
        return lambda: go

    win = window.lockstep_loop(traffic.requests(mix, 1), call, 0.0, 5,
                               lambda r: True, window.no_span, decide, "s")
    assert len(win.records) == 5 and posted == [True] * 4 + [False]
    assert sorted(win.answers) == list(range(5))
    # another rank follows rank 0's word to stop, not its own clock
    win = window.lockstep_loop(traffic.requests(mix, 1), call, 60.0, 1,
                               None, window.no_span,
                               lambda go: lambda: False, "s")
    assert len(win.records) == 1 and win.answers == {}


def test_the_fixture_rows_are_the_same_at_every_world():
    path = fixture_cell.FIXTURE / "generators" / "fixture_rows.py"
    spec = importlib.util.spec_from_file_location("fixture_rows", path)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    config = json.loads((fixture_cell.FIXTURE / "configs" /
                         "fixture_lineitem.json").read_text())
    n = 3 * gen.BLOCK + 12345           # shares cross the blocks

    def seed_of(name):
        return traffic.subseed(SEED, "data", name)

    cpu = torch.device("cpu")
    for name in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"):
        whole = gen.rows(name, config, 0, n, seed_of, cpu)
        assert whole.dtype == torch.float64 and whole.numel() == n
        assert torch.equal(whole, gen.column(name, config, n, seed_of, cpu))
        for world in (2, 4):
            parts = [gen.rows(name, config, *ranks.rows_of(n, world, r,
                                                           102400),
                              seed_of, cpu) for r in range(world)]
            joined = torch.cat(parts)
            assert torch.equal(joined.view(torch.int64),
                               whole.view(torch.int64))


def test_the_shares_are_runs_of_whole_rowgroups():
    for n in (5 * 102400, ROWS, 10**7 + 3):
        groups = -(-n // 102400)
        for world in (1, 2, 4):
            got = [ranks.rows_of(n, world, r, 102400) for r in range(world)]
            assert got[0][0] == 0 and got[-1][1] == n
            for r, (lo, hi) in enumerate(got):
                assert lo == groups * r // world * 102400
                assert lo % 102400 == 0 and lo < hi
                if r:
                    assert got[r - 1][1] == lo
    with pytest.raises(ValueError):
        ranks.rows_of(3 * 102400, 4, 0, 102400)


def test_least_seconds_on_one_chip_is_unchanged_and_scales_with_chips():
    name = "NVIDIA H100 80GB HBM3"
    hbm, int_rate, fp64_rate, fp32_rate = roofline.rates(name)
    for work in ({"bytes": 3e9, "int_ops": 1e9, "float_ops": 2e8,
                  "f64": True},
                 {"bytes": 1e6, "int_ops": 9e12, "float_ops": 7e11,
                  "f64": False}):
        before = max(work["bytes"] / hbm, work["int_ops"] / int_rate,
                     work["float_ops"] / (fp64_rate if work["f64"]
                                          else fp32_rate))
        assert roofline.least_seconds(work, name) == before
        assert roofline.least_seconds(work, name, chips=4) == \
            pytest.approx(before / 4, rel=1e-15)
    assert roofline.least_seconds(work, "cpu", chips=4) is None


def test_the_shares_infos_sum_to_the_whole_columns():
    rng = np.random.default_rng(5)
    x = np.round(rng.uniform(0, 500, 3 * 102400 + 999), 2)
    x[::977] = np.pi                    # exceptions
    whole = roofline.column_info(alp_tpu_torch.compress(x),
                                 torch.from_numpy(x))
    shares = []
    for r in range(2):
        lo, hi = ranks.rows_of(x.size, 2, r, 102400)
        part = x[lo:hi]
        shares.append(roofline.column_info(alp_tpu_torch.compress(part),
                                           torch.from_numpy(part)))
    assert roofline.summed(shares) == whole


def test_a_rank_that_raises_in_setup_ends_the_run(tmp_path):
    root, cell = _install(tmp_path, 2, fault="raise")
    out, took = _run(root, cell, deadline=200)
    assert out.returncode != 0 and took < 200
    assert "{" not in out.stdout
    assert "rank 1: " in out.stderr and "planted fault" in out.stderr
    pids = _spawned(out.stderr)
    assert len(pids) == 1 and not any(_alive(p) for p in pids)


def test_a_killed_rank_ends_the_run(tmp_path):
    root, cell = _install(tmp_path, 2, fault="kill")
    out, took = _run(root, cell, seconds=30, deadline=200)
    assert out.returncode != 0 and took < 100
    assert "{" not in out.stdout
    pids = _spawned(out.stderr)
    assert len(pids) == 1 and not any(_alive(p) for p in pids)


def test_a_request_that_failed_on_one_rank_has_failed(tmp_path):
    root, cell = _install(tmp_path, 2, fault="fail")
    out, _ = _run(root, cell, seconds=2)
    assert out.returncode == 0, out.stderr[-4000:]
    result = _result(out)
    assert result["failed"] == 1 and not result["correct"]
    assert result["checks"]["unanswered"]["value"] == 1
    assert result["checks"]["ranks_disagree"]["value"] == 0
    assert "query_p95_ms" in result["metrics"]


def test_a_rank_that_hangs_is_killed_at_the_deadline(tmp_path):
    root, cell = _install(tmp_path, 2, fault="hang")
    out, took = _run(root, cell, deadline=20)
    assert out.returncode != 0 and 18 < took < 60, (took, out.stderr)
    assert "{" not in out.stdout
    assert "the deadline passed; every rank killed" in out.stderr
    pids = _spawned(out.stderr)
    assert len(pids) == 1 and not any(_alive(p) for p in pids)


def test_a_rank_that_answers_otherwise_sets_ranks_disagree(tmp_path):
    root, cell = _install(tmp_path, 2, fault="disagree")
    out, _ = _run(root, cell)
    assert out.returncode == 0, out.stderr[-4000:]
    result = _result(out)
    checks = result["checks"]
    assert not result["correct"]
    assert checks["count_gap"]["value"] == 0
    assert checks["ranks_disagree"]["value"] == result["attempted"] > 0
    assert "check ranks_disagree:" in out.stderr.splitlines()[-1]


def test_the_control_fails_the_fixture_cell(tmp_path):
    root, cell = _install(tmp_path, 2)
    out, _ = _run(root, cell, "--seeds", "3", str(2**33 + 7),
                  script="control.py")
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(s) for s in out.stdout.splitlines()]
    assert [line["seed"] for line in lines] == [3, 2**33 + 7]
    for line in lines:
        assert not line["control_passed"] and line["checked"] >= 6
        assert line["numbers"]["count_gap"]["value"] > 0
        assert line["numbers"]["unchecked"]["value"] == 0


def test_a_multi_rank_configuration_without_rows_is_refused(tmp_path):
    root, cell = _install(tmp_path, 2, generator="tpch_lineitem")
    out, _ = _run(root, cell)
    assert out.returncode != 0 and "{" not in out.stdout
    assert "has no rows(" in out.stderr and not _spawned(out.stderr)
