"""What decides ``correct``: sound runs pass; the control (the reference
in float32 in the program's place) and the faults a cell can have fail.

Each cell runs through the whole harness on the CPU at a small size (the
program's plain versions), with the look for a card skipped.  The faults
(``FAULTS``): every answer altered by one unit where the program produces
it (a SUM or quantile one ulp up, a COUNT one more, one decoded value's
lowest bit flipped), and half of each column left out (every bucket of
the kept plan cut to its first half of vectors).  The cells are one
client on one card, so no fault of an exchange between cards applies.
``test_cells_on_the_card`` runs each cell on a card, at a small size.
"""

import dataclasses
import math
import time

import numpy as np
import pytest
import torch

import alp_tpu_torch
from alp_tpu_torch import container
from harness import cell, check, control, spec
from test_perfbench_harness import ROOT, TINY, tiny

CELLS = ("lineitem_sf100.agg", "alp_paper_f64.scan",
         "lineitem_sf100.order_stats")
QUERIES = ("query_sum", "query_mean", "query_filter_count",
           "query_filter_sum", "query_quantile", "query_median",
           "query_topk")


def _run(name, seed=2**31 + 21, device="cpu", rows=TINY, seconds=0.2,
         traced=False):
    b = spec.Bench(ROOT)
    wl = tiny(b.workload(name), rows)
    return cell.run(b, wl, seed, seconds, traced, device,
                    time.perf_counter())


def _altered(x):
    if isinstance(x, torch.Tensor):
        y = x.clone()
        flat = y.view(-1).view(torch.int64)
        flat[flat.numel() // 3] ^= 1
        return y
    if isinstance(x, np.ndarray):
        y = x.copy()
        y[0] = np.nextafter(y[0], np.inf)
        return y
    if isinstance(x, (int, np.integer)):
        return x + 1
    return type(x)(math.nextafter(float(x), math.inf))


def _alter_answers(mp):
    for q in QUERIES:
        orig = getattr(alp_tpu_torch, q)
        mp.setattr(alp_tpu_torch, q,
                   lambda *a, _f=orig, **k: _altered(_f(*a, **k)))
    run = container.CompressedColumn.plan

    def plan(self, device=None):
        p = run(self, device)
        if not hasattr(p, "_altered"):
            orig_run = p.run
            p.run = lambda: _altered(orig_run())
            p._altered = True
        return p

    mp.setattr(container.CompressedColumn, "plan", plan)


def _leave_half_out(mp):
    build = container.CompressedColumn.plan

    def plan(self, device=None):
        p = build(self, device)
        if not hasattr(p, "_halved"):
            kept = []
            for b in p.buckets:
                h = max(1, b.n_vectors // 2)
                kept.append(dataclasses.replace(
                    b, rows=b.rows[:h], args=tuple(a[:h] for a in b.args)))
            p.buckets = kept
            p._halved = True
        return p

    mp.setattr(container.CompressedColumn, "plan", plan)


FAULTS = {"answer_altered": _alter_answers, "half_left_out": _leave_half_out}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result, lines = _run(name)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] >= 3
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_makes_the_run_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, lines = _run(name)
    assert not result["correct"], lines
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 2**33 + 1])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, seed):
    b = spec.Bench(ROOT)
    wl = tiny(b.workload(name))
    numbers, checked = control.run(b, wl, seed, torch.device("cpu"))
    assert checked >= 6
    assert not check.passed(numbers), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cells_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for traced in (False, True):
        result, lines = _run(name, device="cuda", rows=1 << 22,
                             seconds=1.0, traced=traced)
        assert result["correct"], lines
        assert result["device"]["platform"] == "gpu"
        if traced:
            assert result["device"]["busy_s"] > 0
