"""The readers of the program's own spans and counters.

``engine_self_ms_per_query``, ``fetches_per_query`` and
``launch_us_per_op`` read the program's ``alp.*`` spans inside the traced
window's requests; ``plan_build_s`` and ``compress_host_s`` read
``alp_tpu_torch.tracing.totals()``.  Each returns None where what it
reads is absent: a program without spans, a trace without them, or no
trace."""

import sys
import time

import pytest

from alp_tpu_torch import tracing
from harness import cell, spec, trace
from test_perfbench_harness import ROOT, TINY, _window, tiny

SPAN_METRICS = ("engine_self_ms_per_query", "fetches_per_query",
                "launch_us_per_op")
TOTAL_METRICS = ("plan_build_s", "compress_host_s")


def _events(program=True):
    """Two requests; with ``program`` the port's spans inside them."""
    ev = []

    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)

    x("user_annotation", "request.sum@a", 0, 100)
    x("user_annotation", "engine.query_sum", 5, 90)
    x("cuda_runtime", "cudaLaunchKernel", 15, 3, corr=1)
    x("kernel", "k7", 20, 30, corr=1)
    x("user_annotation", "request.quantile@b", 110, 50)
    x("user_annotation", "engine.query_quantile", 112, 40)
    x("cuda_runtime", "cudaLaunchKernel", 125, 2, corr=2)
    x("kernel", "k17", 130, 10, corr=2)
    x("user_annotation", "alp.plan.build", 200, 30)      # no request's
    if program:
        x("user_annotation", "alp.engine.query_sum", 6, 88)      # 88
        x("user_annotation", "alp.kernel.falp_decode_f64_exact_sum", 10,
          10)                                                    # - 10
        x("user_annotation", "alp.fetch.sum.totals", 30, 40)     # - 40
        x("user_annotation", "alp.engine.sum.join", 72, 6)       # self
        x("user_annotation", "alp.gc", 74, 2)                    # self
        x("user_annotation", "alp.engine.query_quantile", 113, 38)  # 38
        x("user_annotation", "alp.engine.rank.pass", 114, 30)
        x("user_annotation", "alp.engine.rank.probes", 115, 5)
        x("user_annotation", "alp.fetch.keys.upload", 118, 1)    # - 1
        x("user_annotation", "alp.kernel.rank_pass_alp", 121, 6)  # - 6
        x("user_annotation", "alp.fetch.rank.bins", 128, 12)     # - 12
        x("user_annotation", "alp.engine.rank.narrow", 141, 2)
    return ev


def _run(tr, n=2):
    return cell.Run(_window([0.1] * n), 1.0, {}, [None] * n, tr, "x")


def test_span_readers_on_a_synthetic_trace():
    b = spec.Bench(ROOT)
    run = _run(trace.from_events(_events()))
    assert b.metric("engine_self_ms_per_query").read(run) == \
        pytest.approx(((88 - 10 - 40) + (38 - 1 - 6 - 12)) / 2 * 1e-3)
    assert b.metric("fetches_per_query").read(run) == pytest.approx(3 / 2)
    assert b.metric("launch_us_per_op").read(run) == pytest.approx(8.0)


def test_the_gaps_are_named_by_the_program_s_spans():
    tr = trace.from_events(_events())
    assert tr.host_at(60.0) == "alp.fetch.sum.totals"
    assert tr.host_at(75.0) == "alp.gc"
    assert tr.host_at(141.5) == "alp.engine.rank.narrow"
    tr = trace.from_events(_events(program=False))
    assert tr.host_at(60.0) == "engine.query_sum"


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_read_nothing_without_the_program_s_spans(name):
    b = spec.Bench(ROOT)
    assert b.metric(name).read(_run(trace.from_events(
        _events(program=False)))) is None
    assert b.metric(name).read(_run(None)) is None


def test_launch_us_per_op_needs_a_kernel_span():
    ev = [e for e in _events() if not e["name"].startswith("alp.kernel.")]
    run = _run(trace.from_events(ev))
    b = spec.Bench(ROOT)
    assert b.metric("launch_us_per_op").read(run) is None
    assert b.metric("fetches_per_query").read(run) == pytest.approx(1.5)


def test_counter_readers_read_the_program_s_totals():
    b = spec.Bench(ROOT)
    tracing.reset("alp.plan.build", "alp.compress", "alp.fetch.compress.x")
    assert b.metric("plan_build_s").read(_run(None)) is None
    assert b.metric("compress_host_s").read(_run(None)) is None
    with tracing.span("alp.plan.build"):
        time.sleep(0.01)
    with tracing.span("alp.compress"):
        time.sleep(0.01)
        with tracing.span("alp.fetch.compress.x"):
            time.sleep(0.02)
    spans = tracing.totals()["spans"]
    assert b.metric("plan_build_s").read(_run(None)) == \
        spans["alp.plan.build"]["seconds"] >= 0.01
    got = b.metric("compress_host_s").read(_run(None))
    assert got == pytest.approx(spans["alp.compress"]["seconds"]
                                - spans["alp.fetch.compress.x"]["seconds"])
    assert 0.01 <= got < 0.02


@pytest.mark.parametrize("name", TOTAL_METRICS)
def test_counter_readers_read_nothing_from_a_program_without_tracing(
        name, monkeypatch):
    monkeypatch.setitem(sys.modules, "alp_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["alp_tpu_torch"], "tracing")
    assert spec.Bench(ROOT).metric(name).read(_run(None)) is None


@pytest.mark.parametrize("name", ["lineitem_sf100.agg",
                                  "lineitem_sf100.order_stats",
                                  "alp_paper_f64.scan"])
def test_a_traced_cpu_run_reports_the_program_s_metrics(name):
    """On the CPU the kernels run their plain versions, which have no
    kernel span: every new metric but ``launch_us_per_op`` reads."""
    b = spec.Bench(ROOT)
    wl = tiny(b.workload(name), TINY)
    result, lines = cell.run(b, wl, 2**31 + 77, 0.2, True, "cpu",
                             time.perf_counter())
    assert result["correct"], lines
    got = result["metrics"]
    assert got["plan_build_s"]["value"] > 0
    assert got["compress_host_s"]["value"] > 0
    assert "launch_us_per_op" not in got
    if name != "alp_paper_f64.scan":
        assert got["engine_self_ms_per_query"]["value"] > 0
        assert got["fetches_per_query"]["value"] >= 1
