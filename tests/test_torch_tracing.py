"""The port's spans and counters (``alp_tpu_torch.tracing``).

On the CPU: every query kind run under a CPU profiler gives its declared
spans, each inside the span its layer declares; the bisection's
``alp.engine.rank.pass`` spans count ``engine.LAST_RANK_PASSES``; with
no profiler a span never calls into the profiler and ``totals()`` counts
all the same; the kernel modules' ``LAUNCHES`` and ``reset_launches``
read, write and reset as plain dicts did; a sharded SUM and COUNT WHERE
on two gloo ranks open ``alp.parallel.*`` spans around their collectives,
waits and join, and count the collectives and their bytes.

On the card (marker ``cuda``): each query and a scan run under
``torch.cuda.set_sync_debug_mode("error")``, lifted inside
``alp.fetch.*`` spans, so a wait on the device anywhere else fails (as
far as the mode detects one); each fetch span waits for a kernel queued
before it, and under a profiler every device operation of the call is
launched inside an ``alp.*`` span.  This file imports neither
JAX nor ``alp_tpu``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_tracing.py
"""

import gc
import json
import time

import numpy as np
import pytest
import torch

import alp_tpu_torch
from alp_tpu_torch import constants as C
from alp_tpu_torch import device_compress, engine, tracing
from alp_tpu_torch.columns import route_columns
from alp_tpu_torch.kernels import encode, exact_sum, falp, ffor, group, keys
from alp_tpu_torch.kernels import score

# query -> the call, on a column and a device
QUERIES = {
    "query_sum": lambda col, d: engine.query_sum(col, device=d),
    "query_mean": lambda col, d: engine.query_mean(col, device=d),
    "query_filter_count": lambda col, d: engine.query_filter_count(
        col, -0.5, 0.5, device=d),
    "query_filter_sum": lambda col, d: engine.query_filter_sum(
        col, -0.5, 0.5, device=d),
    "query_min": lambda col, d: engine.query_min(col, device=d),
    "query_max": lambda col, d: engine.query_max(col, device=d),
    "query_topk": lambda col, d: engine.query_topk(col, 7, device=d),
    "query_topk[decode]": lambda col, d: engine.query_topk(
        col, col.n_vectors + 5, largest=False, device=d),
    "query_histogram": lambda col, d: engine.query_histogram(
        col, [-1.0, 0.0, 1.0], device=d),
    "query_quantile": lambda col, d: engine.query_quantile(
        col, [0.1, 0.5, 0.93], device=d),
    "query_median": lambda col, d: engine.query_median(col, device=d),
    "query_groupby": lambda col, d: engine.query_groupby(
        col, np.arange(col.n_values) * 5 // col.n_values, 5, device=d),
    "query_groupby[unordered]": lambda col, d: engine.query_groupby(
        col, np.arange(col.n_values) % 3, 3, device=d),
    "query_window": lambda col, d: engine.query_window(col, 3000, hop=1500,
                                                       device=d),
    "query_distinct": lambda col, d: engine.query_distinct(col, device=d),
    "query_scan": lambda col, d: engine.query_scan(col, device=d)[1],
}

# a span -> the name (or names) of the span it lies directly inside
PARENTS = {
    "alp.engine.sum.join": ("alp.engine.query_sum", "alp.engine.query_mean",
                            "alp.engine.query_filter_sum"),
    "alp.fetch.sum.totals": ("alp.engine.query_sum", "alp.engine.query_mean"),
    "alp.fetch.filter_sum.totals": ("alp.engine.query_filter_sum",),
    "alp.engine.rank.pass": ("alp.engine.query_quantile",),
    "alp.engine.rank.probes": ("alp.engine.rank.pass",),
    "alp.engine.rank.narrow": ("alp.engine.rank.pass",),
    "alp.fetch.rank.bins": ("alp.engine.rank.pass",),
    "alp.engine.query_quantile": ("alp.engine.query_median", None),
    "alp.engine.groups.finish": ("alp.engine.query_groupby",
                                 "alp.engine.query_window"),
    "alp.plan.patch": ("alp.plan.run", "alp.plan.decode_vectors",
                       "alp.plan.decode_rd"),
    "alp.plan.decode_vectors": ("alp.engine.query_topk",),
    "alp.fetch.decode_vectors.select": ("alp.plan.decode_vectors",),
    "alp.fetch.topk.candidates": ("alp.engine.query_topk",),
    "alp.fetch.topk.result": ("alp.engine.query_topk",),
    "alp.fetch.key_extent": ("alp.engine.query_quantile",
                             "alp.engine.query_min", "alp.engine.query_max"),
    "alp.fetch.keys.upload": ("alp.engine.rank.pass",
                              "alp.engine.query_filter_count",
                              "alp.engine.query_histogram",
                              "alp.engine.query_topk"),
    "alp.fetch.prefix_counts": ("alp.engine.query_filter_count",
                                "alp.engine.query_histogram",
                                "alp.engine.query_topk"),
}

# query -> spans it must hold (beside its own ``alp.engine.<query>``)
DECLARED = {
    "query_sum": {"alp.fetch.sum.totals", "alp.engine.sum.join"},
    "query_mean": {"alp.fetch.sum.totals", "alp.engine.sum.join"},
    "query_filter_count": {"alp.fetch.keys.upload",
                           "alp.fetch.prefix_counts"},
    "query_filter_sum": {"alp.fetch.filter_sum.totals",
                         "alp.engine.sum.join"},
    "query_min": {"alp.fetch.key_extent"},
    "query_max": {"alp.fetch.key_extent"},
    "query_topk": {"alp.fetch.topk.candidates", "alp.plan.decode_vectors",
                   "alp.fetch.decode_vectors.select", "alp.plan.patch",
                   "alp.fetch.csr.total", "alp.fetch.topk.valid",
                   "alp.fetch.topk.above", "alp.fetch.topk.result"},
    "query_topk[decode]": {"alp.plan.run", "alp.plan.patch",
                           "alp.fetch.topk.result"},
    "query_histogram": {"alp.fetch.prefix_counts"},
    "query_quantile": {"alp.engine.rank.pass", "alp.engine.rank.probes",
                       "alp.engine.rank.narrow", "alp.fetch.rank.bins",
                       "alp.fetch.keys.upload"},
    "query_median": {"alp.engine.query_quantile", "alp.engine.rank.pass"},
    "query_groupby": {"alp.engine.groups.finish", "alp.fetch.groups.ordered"},
    "query_groupby[unordered]": {"alp.engine.groups.finish",
                                 "alp.fetch.groups.unordered",
                                 "alp.fetch.groups.keys_upload"},
    "query_window": {"alp.engine.groups.finish", "alp.fetch.groups.ordered"},
    "query_distinct": {"alp.plan.run", "alp.fetch.distinct.count"},
    "query_scan": {"alp.plan.run", "alp.plan.patch"},
}

KERNEL_MODULES = (falp, exact_sum, keys, group, ffor, encode, score)


def _column():
    """A column of an ALP and an ALP_RD rowgroup, with exceptions, NaNs
    and a tail."""
    cols = route_columns(np.random.default_rng(11), C.N_VECTORS_PER_ROWGROUP)
    x = np.concatenate([cols["bench_bw11_city_temperature"],
                        cols["f64_alp_rd"][: 1024 * 20 + 333]])
    x[5::997] = np.nan
    return alp_tpu_torch.compress(x)


@pytest.fixture(scope="module")
def col():
    return _column()


def _trace_events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())
    return ev["traceEvents"] if isinstance(ev, dict) else ev


def _spans(events) -> list:
    """The program's spans of a trace: (start, end, name), sorted by start
    and, at one start, the longer first."""
    got = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            e["name"]) for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e["name"].startswith("alp.") and e["name"] != "alp.gc"]
    return sorted(got, key=lambda s: (s[0], -s[1]))


def _parents(spans) -> list:
    """(span, the innermost span it lies in, or None) of each span."""
    out, stack = [], []
    for s in spans:
        while stack and not (stack[-1][0] <= s[0] and s[1] <= stack[-1][1]):
            stack.pop()
        out.append((s, stack[-1] if stack else None))
        stack.append(s)
    return out


def _profiled(fn, tmp_path, cuda=False) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    return _trace_events(prof, tmp_path)


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_each_query_gives_its_declared_spans_nested_as_declared(
        query, col, tmp_path):
    plan = col.plan("cpu")
    plan.key_extent = plan.vector_sums = None     # as at the first query
    events = _profiled(lambda: QUERIES[query](col, "cpu"), tmp_path)
    spans = _spans(events)
    own = "alp.engine." + query.split("[")[0]
    tops = [s for s, parent in _parents(spans) if parent is None]
    assert [t[2] for t in tops] == [own], tops
    names = {s[2] for s in spans}
    assert DECLARED[query] <= names, DECLARED[query] - names
    assert not any(n.startswith("alp.kernel.") for n in names)   # plain runs
    for s, parent in _parents(spans):
        if s[2] in PARENTS:
            assert (parent and parent[2]) in PARENTS[s[2]], (s[2], parent)


def test_rank_pass_spans_count_the_last_rank_passes(col, tmp_path):
    col.plan("cpu")
    before = tracing.totals()["spans"].get("alp.engine.rank.pass",
                                           {"calls": 0})["calls"]
    events = _profiled(lambda: engine.query_quantile(
        col, np.linspace(0.01, 0.99, 9), device="cpu"), tmp_path)
    passes = [s for s in _spans(events) if s[2] == "alp.engine.rank.pass"]
    assert len(passes) == engine.LAST_RANK_PASSES >= 2
    after = tracing.totals()["spans"]["alp.engine.rank.pass"]["calls"]
    assert after - before == engine.LAST_RANK_PASSES
    assert tracing.totals()["counts"]["alp.engine.rank.last_passes"] == \
        engine.LAST_RANK_PASSES
    assert tracing.totals()["counts"]["alp.engine.rank.last_bisections"] == \
        engine.LAST_RANK_BISECTIONS == 1


def test_without_a_profiler_no_span_enters_the_profiler(col, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    col.plan("cpu")
    before = tracing.totals()["spans"]
    for call in QUERIES.values():
        call(col, "cpu")
    gc.collect()
    got = tracing.totals()["spans"]
    for name in ("alp.engine.query_sum", "alp.engine.rank.pass",
                 "alp.fetch.topk.candidates", "alp.plan.run", "alp.gc"):
        was = before.get(name, {"calls": 0, "seconds": 0.0})
        assert got[name]["calls"] > was["calls"], name
        assert got[name]["seconds"] > was["seconds"], name


def test_spans_keep_calls_seconds_and_their_fetches():
    tracing.reset("t.outer", "t.inner", "alp.fetch.t")
    with tracing.span("t.outer"):
        with tracing.span("t.inner"):
            with tracing.span("alp.fetch.t"):
                pass
        with tracing.span("alp.fetch.t"):
            pass
    got = tracing.totals()["spans"]
    fetch = got["alp.fetch.t"]
    assert fetch["calls"] == 2 and fetch["fetch_seconds"] == 0.0
    assert got["t.outer"]["calls"] == 1
    assert got["t.outer"]["fetch_seconds"] == pytest.approx(
        fetch["seconds"])
    assert 0 < got["t.inner"]["fetch_seconds"] < \
        got["t.outer"]["fetch_seconds"]
    assert got["t.outer"]["seconds"] >= got["t.inner"]["seconds"]
    tracing.reset("t.outer")
    assert "t.outer" not in tracing.totals()["spans"]
    assert "t.inner" in tracing.totals()["spans"]


def test_a_kernel_span_wraps_card_calls_alone():
    class OnCard:
        is_cuda = True

    @tracing.kernel
    def fake_wrapper(first, n):
        return n + 1

    tracing.reset("alp.kernel.fake_wrapper")
    assert fake_wrapper(torch.zeros(1), 1) == 2        # a plain run
    assert "alp.kernel.fake_wrapper" not in tracing.totals()["spans"]
    assert fake_wrapper(OnCard(), 2) == 3
    assert tracing.totals()["spans"]["alp.kernel.fake_wrapper"][
        "calls"] == 1
    assert fake_wrapper.__name__ == "fake_wrapper"


def test_launch_views_count_and_reset_as_dicts():
    old = {m: dict(m.LAUNCHES) for m in KERNEL_MODULES}
    assert list(falp.LAUNCHES) == [
        "falp_decode_f64", "falp_decode_f32", "rd_decode_dict_f64",
        "rd_decode_dict_f32", "variant_sum_f64", "rd_glue_f64",
        "rd_glue_f32"]
    assert list(keys.LAUNCHES) == ["key_counts", "key_extremes",
                                   "rank_pass"]
    try:
        keys.LAUNCHES["rank_pass"] += 3
        assert keys.LAUNCHES["rank_pass"] == old[keys]["rank_pass"] + 3
        assert tracing.totals()["counts"]["alp.launch.rank_pass"] == \
            keys.LAUNCHES["rank_pass"]
        keys.reset_launches()
        assert dict(keys.LAUNCHES) == {"key_counts": 0, "key_extremes": 0,
                                       "rank_pass": 0}
        group.LAUNCHES.update({"group_reduce": 4})
        merged = {**falp.LAUNCHES, **group.LAUNCHES}
        assert merged["group_reduce"] == 4 and len(merged) == 10
        with pytest.raises(KeyError):
            falp.LAUNCHES["no_such_kernel"]
        with pytest.raises(KeyError):
            falp.LAUNCHES["no_such_kernel"] = 1
        assert {k: v for m in KERNEL_MODULES
                for k, v in m.LAUNCHES.items()}.keys() == \
            {k for d in old.values() for k in d}
    finally:
        for m, counts in old.items():
            m.LAUNCHES.update(counts)


def test_plain_runs_count_no_launch(col):
    before = {m: dict(m.LAUNCHES) for m in KERNEL_MODULES}
    col.plan("cpu")
    for call in QUERIES.values():
        call(col, "cpu")
    assert {m: dict(m.LAUNCHES) for m in KERNEL_MODULES} == before


def test_device_compress_keeps_its_stages_and_bytes_to_host():
    x = _column().plan("cpu").run().reshape(-1)
    device_compress.reset_to_host()
    tracing.reset("alp.compress", "alp.compress.encode",
                  "alp.fetch.compress.meta")
    got = alp_tpu_torch.compress_device(x.numpy(), device="cpu")
    assert got.to_bytes() == alp_tpu_torch.compress(x.numpy()).to_bytes()
    spans = tracing.totals()["spans"]
    assert spans["alp.compress"]["calls"] == 1
    assert spans["alp.compress.encode"]["fetch_seconds"] >= \
        spans["alp.fetch.compress.meta"]["seconds"] > 0
    assert spans["alp.compress"]["fetch_seconds"] > 0
    assert device_compress.TO_HOST["bytes"] == 0        # nothing on a card


# the spans a sharded query opens, and the one each lies directly inside
PARALLEL_PARENTS = {
    "alp.parallel.all_gather": "alp.parallel.sum",
    "alp.fetch.parallel.sizes": "alp.parallel.sum",
    "alp.fetch.parallel.rows": "alp.parallel.sum",
    "alp.parallel.join": "alp.parallel.sum",
    "alp.parallel.all_reduce": "alp.parallel.filter_count",
    "alp.fetch.parallel.count": "alp.parallel.filter_count",
}


def test_sharded_queries_open_their_spans_and_count_what_moved(tmp_path):
    """A sharded SUM and COUNT WHERE on two gloo ranks (their share made
    first): each query's span holds its collectives, waits and join, and
    the counters count three collectives and their bytes: the SUM's two
    all-gathers (a byte count a rank, then one row of W + 3 int64 a rank)
    and the COUNT's all-reduce of three int64 bins."""
    import torch_parallel_worker as worker

    world = 2
    out = worker.spawn_ranks(world, "cpu", str(tmp_path), deadline=240.0,
                             target=worker.run_trace_rank)
    width = exact_sum.WINDOWS[torch.int64] + 3
    for r in out:
        spans = sorted(r["spans"], key=lambda s: (s[0], -s[1]))
        names = {s[2] for s in spans}
        assert {"alp.parallel.sum", "alp.parallel.filter_count"} <= names
        assert set(PARALLEL_PARENTS) <= names, set(PARALLEL_PARENTS) - names
        for s, parent in _parents(spans):
            if s[2] in PARALLEL_PARENTS:
                assert parent[2] == PARALLEL_PARENTS[s[2]], (s, parent)
        totals = r["totals"]
        assert totals["spans"]["alp.parallel.all_gather"]["calls"] == 2
        assert totals["spans"]["alp.parallel.all_reduce"]["calls"] == 1
        assert totals["counts"]["alp.parallel.collectives"] == 3
        assert totals["counts"]["alp.parallel.bytes"] == \
            world * 8 + world * width * 8 + 3 * 8
    assert len({r["sum"] for r in out}) == len({r["count"] for r in out}) == 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


class _Waits:
    """While installed: the sync debug mode "error" outside ``alp.fetch.*``
    spans and off inside them, and each fetch span starts behind a kernel
    that spins ``SLEEP_S`` seconds (``torch.cuda._sleep``); ``names`` lists
    each fetch span entered and ``waited`` whether the host waited for that
    kernel inside it."""
    SLEEP_CYCLES = 50_000_000        # ~25 ms at the H100's 1.98 GHz
    SLEEP_S = 0.010                  # a span this long waited for it

    def __init__(self, monkeypatch):
        self.names, self.waited, self._open = [], [], []
        enter, leave = tracing.span.__enter__, tracing.span.__exit__

        def __enter__(span):
            if span.name.startswith(tracing.FETCH):
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda._sleep(self.SLEEP_CYCLES)
                self._open.append(time.perf_counter())
            return enter(span)

        def __exit__(span, *exc):
            out = leave(span, *exc)
            if span.name.startswith(tracing.FETCH):
                took = time.perf_counter() - self._open.pop()
                torch.cuda.set_sync_debug_mode("error")
                self.names.append(span.name)
                self.waited.append(took >= self.SLEEP_S)
            return out

        monkeypatch.setattr(tracing.span, "__enter__", __enter__)
        monkeypatch.setattr(tracing.span, "__exit__", __exit__)

    def run(self, fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def idle(self) -> list:
        """The fetch spans entered that did not wait."""
        return [n for n, w in zip(self.names, self.waited) if not w]


CARD_QUERIES = sorted(QUERIES)


@pytest.mark.cuda
@pytest.mark.parametrize("query", CARD_QUERIES)
def test_every_wait_on_the_card_is_a_named_fetch(query, cuda, monkeypatch,
                                                 tmp_path):
    col = _column()
    plan = col.plan(cuda)
    call = QUERIES[query]
    waits = _Waits(monkeypatch)
    waits.run(lambda: call(col, cuda))   # the first call: kept parts made
    first = list(waits.names)
    assert not waits.idle(), (first, waits.idle())
    waits.names.clear()
    waits.waited.clear()
    waits.run(lambda: call(col, cuda))   # the kept plan's call
    assert not waits.idle(), (waits.names, waits.idle())
    monkeypatch.undo()
    plan.key_extent = plan.vector_sums = None     # the first call again
    events = _profiled(lambda: call(col, cuda), tmp_path, cuda=True)
    spans = _spans(events)
    fetches = [s[2] for s in spans if s[2].startswith(tracing.FETCH)]
    assert sorted(fetches) == sorted(first)
    launch = {(e.get("args") or {}).get("correlation"): float(e["ts"])
              for e in events if e.get("ph") == "X"
              and e.get("cat") in ("cuda_runtime", "cuda_driver")}
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert ops
    for op in ops:
        at = launch.get((op.get("args") or {}).get("correlation"))
        assert at is not None, op["name"]
        assert any(s <= at <= e for s, e, _ in spans), op["name"]
    assert any(s[2].startswith("alp.kernel.") for s in spans)


@pytest.mark.cuda
def test_topk_fetches_are_its_waits(cuda, monkeypatch):
    """TOP-K's ``alp.fetch.*`` spans, as ``fetches_per_query`` counts them,
    are the places it waits: each span waits, and no wait lies outside
    one."""
    col = _column()
    col.plan(cuda)
    engine.query_topk(col, 100, device=cuda)
    waits = _Waits(monkeypatch)
    waits.run(lambda: engine.query_topk(col, 100, device=cuda))
    print(f"TOP-K waits: {len(waits.names)} {waits.names}")
    assert waits.names and not waits.idle(), waits.idle()
