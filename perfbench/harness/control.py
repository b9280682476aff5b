"""The control of the check: the reference in the program's place, one
precision below the configuration's.

The configurations promise exact answers over values of their ``dtype``
and name the precision below it as ``control_dtype`` (float32 below
float64, bfloat16 below float32).  The control answers the cell's
requests from the values rounded to ``control_dtype`` (and back), each by
the plain reference, and the check then holds those answers against the
reference from the values themselves, as it holds the program's.  A
sound check reads the control as not correct.  The control answers as
many requests as a run's check sees at least: ``MIN_CYCLES`` cycles of
the mix.  On several cards each rank rounds its own share, and the
control's answers are joined from the shares as the check's are
(``run_ranks``).
"""

from __future__ import annotations

import collections

import torch

from . import cell, check, traffic, window


def _kept(bench, wl, seed: int) -> tuple:
    """(ops, the requests of ``MIN_CYCLES`` cycles, the kept ones)."""
    mix = wl.traffic
    ops = {t.op: bench.op(t.op) for t in traffic.templates(mix)}
    stream = traffic.requests(mix, seed)
    reqs = [next(stream)
            for _ in range(cell.MIN_CYCLES * traffic.cycle_length(mix))]
    keep = cell.keeper(ops, mix, seed)
    return ops, reqs, [r for r in reqs if keep(r)]


def _records(reqs) -> list:
    return [window.Record(r.index, r.template, r.op, r.column, r.params,
                          0, 0, True) for r in reqs]


def _lowered(values_of, lower):
    def lowered_of(column):
        values = values_of(column)
        return values.to(lower).to(values.dtype)
    return lowered_of


def run(bench, wl, seed: int, device):
    """({number: (value, limit)}, answers checked) of the control on
    ``seed``."""
    values_of = cell.make_values(bench, wl.config, seed, device)
    lower = getattr(torch, wl.config["control_dtype"])
    ops, reqs, kept = _kept(bench, wl, seed)
    by_column = collections.defaultdict(list)
    for r in kept:
        by_column[r.column].append(r)
    answers = {}
    lowered_of = _lowered(values_of, lower)
    for column, rs in by_column.items():
        lowered = lowered_of(column)
        cache = {}
        for r in rs:
            answers[r.index] = ops[r.op].reference(lowered, r.params, cache)
        del lowered, cache
    return check.check(_records(reqs), answers, ops.__getitem__, values_of)


def run_ranks(bench, wl, seed: int, ranks):
    """The control of a cell on several cards, on every rank: each rank
    rounds its own share, and the control's answers are its shares'
    ``reference_share`` parts joined on rank 0, as the check joins the
    expected ones.  Rank 0 returns what ``run`` returns; the others
    None."""
    values_of = cell.make_share_values(bench, wl.config, seed, ranks.rows,
                                       ranks.device)
    lower = getattr(torch, wl.config["control_dtype"])
    ops, reqs, kept = _kept(bench, wl, seed)
    records = _records(reqs)
    qs = check.questions(records, {r.index: None for r in kept},
                         ops.__getitem__)
    control = check.joined(ranks, ops.__getitem__, qs,
                           _lowered(values_of, lower))
    expected = check.joined(ranks, ops.__getitem__, qs, values_of)
    if ranks.rank != 0:
        return None
    answers = {r.index: control[r.column][(r.op, ops[r.op].key(r.params))]
               for r in kept}
    return check.judge(records, answers, ops.__getitem__,
                       lambda column, q: expected[column])
