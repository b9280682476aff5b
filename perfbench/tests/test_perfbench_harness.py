"""The harness: names resolve to files, a cell added as data runs, the
window's arithmetic, the trace's reduction, and the import rules."""

import dataclasses
import itertools
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

import pytest
import torch

import alp_tpu_torch
from harness import cell, spec, trace, traffic, window

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
RUN = BENCH / "run.py"
TINY = 2 * 102400 + 77        # two rowgroups and a tail


def bench():
    return spec.Bench(ROOT)


def tiny(wl, rows=TINY):
    return dataclasses.replace(wl, config={**wl.config, "rows": rows})


def test_every_workload_resolves_to_its_files():
    b = bench()
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert data["paths"] == ["perfbench"]
    e2e = {m["name"] for m in data["end_to_end"]}
    assert {"setup_s", "scan_gb_per_s", "query_p95_ms"} <= e2e
    for c in data["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.parts[len(ROOT.parts)] == "perfbench"
        config = json.loads(path.read_text())
        assert config["name"] == c["name"]
        assert config["reduced"] == c["reduced"]
        b.generator(config["generator"])
    for w in data["workloads"]:
        wl = b.workload(w["name"])
        assert wl.chips == 1
        for t in traffic.templates(wl.traffic):
            op = b.op(t.op)
            assert callable(op.call) and callable(op.reference)
            assert all(limit == 0 for limit in op.NUMBERS.values())
            assert t.column in wl.config["columns"]
        for m in wl.end_to_end + wl.per_layer:
            assert callable(b.metric(m["name"]).read)
        assert {m["name"] for m in wl.end_to_end} == e2e


def test_unknown_names_are_refused():
    b = bench()
    with pytest.raises(KeyError):
        b.workload("no_such.cell")
    with pytest.raises(FileNotFoundError):
        b.op("no_such_op")
    with pytest.raises(ValueError):
        b.metric("../run")


def _copy_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def test_a_cell_added_as_data_alone_runs(tmp_path):
    root = _copy_checkout(tmp_path)
    mix = {"loop": "closed", "clients": 1, "why": "a test mix",
           "templates": [
               {"name": "tax", "op": "sum", "columns": ["l_tax"], "share": 2},
               {"name": "cheap", "op": "filter_count",
                "columns": ["l_extendedprice"],
                "params": {"range": {"range": {"lo": [900, 2000],
                                               "width": [100, 500]},
                                     "round": 2}}}]}
    (root / "perfbench/traffic/test_mix.json").write_text(json.dumps(mix))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["workloads"].append({"name": "lineitem_sf100.test_mix",
                              "config": "tpch_lineitem_sf100",
                              "traffic": "test_mix", "chips": 1,
                              "why": "added as data"})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    b = spec.Bench(root)
    wl = tiny(b.workload("lineitem_sf100.test_mix"))
    assert traffic.cycle_length(wl.traffic) == 3
    result, lines = cell.run(b, wl, 2**31 + 99, 0.2, False, "cpu",
                             time.perf_counter())
    assert result["correct"], lines
    assert set(result["metrics"]) == {"setup_s", "scan_gb_per_s",
                                      "query_p95_ms"}
    assert list(result)[-1] == "checks"


F32_CONFIG = {
    "name": "test_f32", "source": "a float32 configuration made as data",
    "rows": TINY, "dtype": "float32", "control_dtype": "bfloat16",
    "vector_size": 1024, "rowgroup_vectors": 100,
    "generator": "distribution", "reduced": [],
    "columns": {"temp": {"uniform": [-20, 184.7], "decimals": 1},
                "price": {"uniform": [0, 10485.75], "decimals": 2},
                "lat": {"normal": [0.0, 1.0]}}}
F32_MIX = {"loop": "closed", "clients": 1, "why": "every op on float32",
           "templates": [
               {"name": "scan", "op": "scan", "columns": ["temp", "lat"]},
               {"name": "sum", "op": "sum", "columns": ["price", "lat"]},
               {"name": "mean", "op": "mean", "columns": ["temp"]},
               {"name": "count", "op": "filter_count", "columns": ["temp"],
                "params": {"range": [None, 24.1], "hi_open": True}},
               {"name": "band", "op": "filter_sum", "columns": ["price"],
                "params": {"range": {"range": {"lo": [100, 2000],
                                               "width": [10, 500]},
                                     "round": 2}}},
               {"name": "q", "op": "quantile", "columns": ["price"],
                "params": {"q": {"uniform": [0.01, 0.99], "round": 3,
                                 "count": 4}}},
               {"name": "median", "op": "median", "columns": ["lat"]},
               {"name": "top", "op": "topk", "columns": ["temp"],
                "params": {"k": 50, "largest": False}}]}


def test_a_float32_cell_added_as_data_alone_runs_and_its_control_fails(
        tmp_path):
    """A float32 configuration, its mix and its cell are files and entries
    only; the cell runs correct through the harness, its scans count 4
    bytes a value, and its control (bfloat16) is not correct."""
    from harness import check, control, roofline
    root = _copy_checkout(tmp_path)
    (root / "perfbench/configs/test_f32.json").write_text(
        json.dumps(F32_CONFIG))
    (root / "perfbench/traffic/f32_mix.json").write_text(json.dumps(F32_MIX))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "test_f32", "source": "data",
                            "file": "perfbench/configs/test_f32.json",
                            "reduced": [], "why": "float32 as data"})
    data["workloads"].append({"name": "test_f32.mix", "config": "test_f32",
                              "traffic": "f32_mix", "chips": 1,
                              "why": "added as data"})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    b = spec.Bench(root)
    wl = b.workload("test_f32.mix")
    result, lines = cell.run(b, wl, 2**31 + 41, 0.2, False, "cpu",
                             time.perf_counter())
    assert result["correct"], lines
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "scan_gb_per_s",
                                      "query_p95_ms"}
    values = cell.make_values(b, wl.config, 3, torch.device("cpu"))
    assert values("temp").dtype == torch.float32
    col = alp_tpu_torch.compress(values("temp").numpy())
    info = roofline.column_info(col, values("temp"))
    run = cell.Run(_window([1.0]), 1.0, {"c": info}, [], None, "cpu")
    assert b.metric("scan_gb_per_s").read(run) == \
        pytest.approx(4 * TINY / 0.001 / 1e9)
    for seed in (1, 2**31 + 7, 2**33 + 1):
        numbers, checked = control.run(b, wl, seed, torch.device("cpu"))
        assert checked >= 11 and numbers["unchecked"][0] == 0
        assert not check.passed(numbers), numbers


def test_the_stream_is_the_same_work_in_another_order():
    mix = bench().traffic("agg")
    n = traffic.cycle_length(mix)
    a = [next(s) for s in [traffic.requests(mix, 5)] for _ in range(4 * n)]
    b = [next(s) for s in [traffic.requests(mix, 6)] for _ in range(4 * n)]
    again = [next(s) for s in [traffic.requests(mix, 5)] for _ in range(n)]
    assert [r.template for r in a[:n]] == [r.template for r in again]
    assert [r.params for r in a[:n]] == [r.params for r in again]
    for k in range(4):
        cyc_a = sorted(r.template for r in a[k * n:(k + 1) * n])
        cyc_b = sorted(r.template for r in b[k * n:(k + 1) * n])
        assert cyc_a == cyc_b
    assert [r.template for r in a] != [r.template for r in b]
    bands = {tuple(r.params["range"]) for r in a
             if r.template.startswith("price_band")}
    assert len(bands) <= 16


def test_a_drawn_list_is_sorted_and_rounded():
    mix = bench().traffic("order_stats")
    qs = [r.params["q"] for r in itertools.islice(
        traffic.requests(mix, 9), 60) if r.op == "quantile"]
    assert len(qs) >= 10 and len({tuple(q) for q in qs}) == len(qs)
    for q in qs:
        assert len(q) == 10 and q == sorted(q)
        assert all(0.01 <= x <= 0.99 and round(x, 3) == x for x in q)


def _window(latencies_ms, ok=None, start_ns=1_000_000_000):
    recs, t = [], start_ns
    for i, ms in enumerate(latencies_ms):
        t1 = t + int(ms * 1e6)
        recs.append(window.Record(i, "t", "sum", "c", {}, t, t1,
                                  True if ok is None else ok[i]))
        t = t1 + 1_000_000          # 1 ms of harness between requests
    return window.Window(recs, start_ns, recs[-1].t1_ns, {})


def test_a_rate_is_all_the_work_over_all_the_window():
    win = _window([10.0, 30.0, 60.0])          # 100 ms busy, 102 ms window
    got = window.rate(win, lambda r: 1e9)
    assert got == pytest.approx(3e9 / 0.102)
    # a failed request's work is not counted, its time is
    win = _window([10.0, 30.0, 60.0], ok=[True, False, True])
    assert window.rate(win, lambda r: 1e9) == pytest.approx(2e9 / 0.102)


def test_p95_is_taken_over_every_request():
    lat = list(range(1, 101))                   # 1 .. 100 ms
    win = _window(lat)
    assert window.percentile(window.latencies(win), 95) * 1e3 == \
        pytest.approx(95.0)
    # nearest rank: ceil(0.95 * 7) = 7th of 7
    assert window.percentile([5, 1, 7, 3, 2, 6, 4], 95) == 7
    # a failed request counts as missing any limit
    win = _window([1.0] * 19 + [2.0], ok=[True] * 19 + [False])
    lat = window.latencies(win)
    assert math.isinf(max(lat))
    assert window.percentile(lat + [1.0] * 0, 100) == math.inf
    from_metric = bench().metric("query_p95_ms")
    run = cell.Run(_window([1.0] * 18 + [9.0, 9.0], ok=[True] * 18 +
                           [False, False]), 1.0, {}, [], None, "cpu")
    assert from_metric.read(run) is None
    run = cell.Run(_window([1.0] * 18 + [9.0, 9.0]), 1.0, {}, [], None, "cpu")
    assert from_metric.read(run) == pytest.approx(9.0)


def test_the_loop_runs_to_time_and_to_its_least_count():
    calls = []

    def call(req, span):
        calls.append(req.index)
        return req.index, {}

    mix = bench().traffic("scan")
    stream = traffic.requests(mix, 1)
    win = window.closed_loop(stream, call, 0.0, 7, keep=lambda r: False)
    assert len(win.records) == 7 and win.answers == {}

    def fail(req, span):
        raise RuntimeError("lost")

    win = window.closed_loop(traffic.requests(mix, 1), fail, 0.0, 3)
    assert [r.ok for r in win.records] == [False] * 3
    assert "lost" in win.records[0].error


def _events(skew=0.0):
    """Two requests; the device's clock ``skew`` us off the host's."""
    ev = []

    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)

    x("user_annotation", "request.sum@a", 0, 100)
    x("user_annotation", "engine.query_sum", 5, 90)
    x("cuda_runtime", "cudaLaunchKernel", 15, 3, corr=1)
    x("kernel", "k7", 20 + skew, 30, corr=1)
    x("cuda_runtime", "cudaMemcpyAsync", 40, 3, corr=2)
    x("gpu_memcpy", "Memcpy DtoH", 45 + skew, 10, corr=2)   # overlaps k7
    x("user_annotation", "request.sum@b", 110, 50)
    x("user_annotation", "engine.query_sum", 112, 40)
    x("cuda_driver", "cuLaunchKernel", 115, 2, corr=3)
    x("kernel", "k7", 120 + skew, 20, corr=3)
    x("gpu_user_annotation", "engine.query_sum", 20, 40)
    x("kernel", "outside", 300, 5)                       # no request's
    return ev


@pytest.mark.parametrize("skew", [0.0, 60.0, -18.0])
def test_the_trace_reduces_to_busy_idle_and_requests(skew):
    tr = trace.from_events(_events(skew))
    assert tr.window == (0.0, 160.0)
    assert len(tr.device) == 4 and len(tr.requests) == 2
    assert tr.busy_us() == pytest.approx(35 + 20)
    assert tr.per_request() == [(100.0, 35.0, 2), (50.0, 20.0, 1)]
    assert tr.gaps() == [(55.0 + skew, 120.0 + skew)]
    assert tr.host_at(100.0) == "request.sum@a"
    assert tr.host_at(105.0) == "host.between_requests"
    assert tr.host_at(10.0) == "engine.query_sum"
    early = 3 if skew < -5 else 0
    assert tr.clocks() == (early, pytest.approx(5.0 + skew), 1)
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0] == ["k7", pytest.approx(50e-6)]
    assert [g[1] for g in bd["idle_gaps"]] == [pytest.approx(65e-6)]
    run = cell.Run(_window([0.1, 0.05]), 1.0, {}, [20e-6, 10e-6], tr, "x")
    b = bench()
    assert b.metric("device_idle_pct").read(run) == \
        pytest.approx(100 * (1 - 55 / 160))
    assert b.metric("device_ops_per_query").read(run) == 1.5
    assert b.metric("host_ms_per_query").read(run) == \
        pytest.approx((65 + 30) / 2 * 1e-3)
    assert b.metric("roofline_pct").read(run) == \
        pytest.approx(100 * 30 / 55)
    # no peaks for the card: no roofline, never a 0
    run = cell.Run(_window([0.1, 0.05]), 1.0, {}, [None, None], tr, "x")
    assert b.metric("roofline_pct").read(run) is None
    run = cell.Run(_window([0.1]), 1.0, {}, [None], None, "x")
    for name in ("device_idle_pct", "roofline_pct", "device_ops_per_query",
                 "host_ms_per_query", "rank_passes_per_query"):
        assert b.metric(name).read(run) is None


def test_an_operation_without_its_launch_goes_by_its_start():
    ev = [e for e in _events() if e["cat"] not in ("cuda_runtime",
                                                   "cuda_driver")]
    tr = trace.from_events(ev)
    assert [n for _, _, n in tr.per_request()] == [2, 1]


def test_forbidden_modules_compare_whole_top_level_names():
    sys.path.insert(0, str(BENCH))
    import run as bench_run
    assert bench_run.forbidden_modules(
        ["alp_tpu_torch", "alp_tpu_torch.engine", "jaxtyping",
         "numpy"]) == []
    assert bench_run.forbidden_modules(
        ["alp_tpu.engine", "jax.numpy", "jaxlib", "flax.linen",
         "alp_tpu_torch"]) == ["alp_tpu", "flax", "jax", "jaxlib"]


def test_nothing_the_harness_loads_is_jax_or_alp_tpu():
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
import run
from harness import cell, check, control, roofline, spec, trace, traffic
import alp_tpu_torch
b = spec.Bench(run.ROOT)
for w in b.data["workloads"]:
    wl = b.workload(w["name"])
    b.generator(wl.config["generator"])
    for t in traffic.templates(wl.traffic):
        b.op(t.op)
    for m in wl.end_to_end + wl.per_layer:
        b.metric(m["name"])
found = run.forbidden_modules(list(sys.modules))
print("FOUND", found)
sys.exit(1 if found else 0)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "FOUND []" in out.stdout


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(RUN), "--workload",
                          "alp_paper_f64.scan", "--seed", str(2**31 + 5),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_run_alone_in_a_directory_exits_nonzero(tmp_path):
    root = _copy_checkout(tmp_path)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "alp_paper_f64.scan", "--seed", "7", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode != 0
    assert "{" not in out.stdout
