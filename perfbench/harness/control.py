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
the mix.
"""

from __future__ import annotations

import collections

import torch

from . import cell, check, traffic, window


def run(bench, wl, seed: int, device):
    """({number: (value, limit)}, answers checked) of the control on
    ``seed``."""
    mix = wl.traffic
    values_of = cell.make_values(bench, wl.config, seed, device)
    lower = getattr(torch, wl.config["control_dtype"])
    ops = {t.op: bench.op(t.op) for t in traffic.templates(mix)}
    stream = traffic.requests(mix, seed)
    reqs = [next(stream)
            for _ in range(cell.MIN_CYCLES * traffic.cycle_length(mix))]
    keep = cell.keeper(ops, mix, seed)
    kept = [r for r in reqs if keep(r)]
    by_column = collections.defaultdict(list)
    for r in kept:
        by_column[r.column].append(r)
    answers = {}
    for column, rs in by_column.items():
        values = values_of(column)
        lowered = values.to(lower).to(values.dtype)
        del values
        cache = {}
        for r in rs:
            answers[r.index] = ops[r.op].reference(lowered, r.params, cache)
        del lowered, cache
    records = [window.Record(r.index, r.template, r.op, r.column, r.params,
                             0, 0, True) for r in reqs]
    return check.check(records, answers, ops.__getitem__, values_of)
