"""COUNT(*) WHERE lo <= v <= hi: ``alp_tpu_torch.query_filter_count``.

``range`` is [lo, hi]; a null lo is -inf.  The bounds are taken in the
column's dtype, as the port rounds them; ``hi_open`` makes the upper
bound strict (v < hi), through the largest value of that dtype below
hi."""

import numpy as np

import alp_tpu_torch
from harness import roofline
from reference import plain

SPAN = "engine.query_filter_count"
NUMBERS = {"count_gap": 0}


def bounds(params, dtype):
    """(lo, hi) as floats that the column's ``dtype`` holds exactly."""
    dt = np.dtype(dtype).type
    lo, hi = params["range"]
    lo = dt(-np.inf) if lo is None else dt(lo)
    hi = dt(hi)
    if params.get("hi_open"):
        hi = np.nextafter(hi, dt(-np.inf))
    return float(lo), float(hi)


def call(col, params, device, span):
    lo, hi = bounds(params, col.dtype)
    with span(SPAN):
        return alp_tpu_torch.query_filter_count(col, lo, hi, device=device)


def key(params):
    lo, hi = params["range"]
    return lo, hi, bool(params.get("hi_open"))


def reference(values, params, cache):
    return plain.count_between(values, *bounds(params, plain.dtype(values)))


def compare(answer, expected):
    return {"count_gap": abs(int(answer) - int(expected))}


def work(info, params):
    # two thresholds: a search of two steps and the count
    return roofline.key_work(info, roofline.search_ops(info, 2))
