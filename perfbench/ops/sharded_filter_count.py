"""COUNT(*) WHERE lo <= v <= hi over the cards of a cell on several cards:
``alp_tpu_torch.parallel.share_filter_count`` of the rank's resident share
(K15's bins of each share, all-reduced over the mesh).

``range`` and ``hi_open`` as ``ops/filter_count.py``: the bounds in the
column's dtype, ``hi_open`` making the upper bound strict.  A share's
part of the reference is its count, and the parts join by their sum.

A program without resident shares fails here at once, as the op loads."""

import numpy as np
from alp_tpu_torch.parallel import share_filter_count

from harness import roofline, shares
from reference import plain

SPAN = "parallel.filter_count"
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


def call(col, params, device, span, ranks):
    sh = shares.of(col, ranks)
    lo, hi = bounds(params, sh.dtype)
    with span(SPAN):
        return share_filter_count(sh, lo, hi)


def key(params):
    lo, hi = params["range"]
    return lo, hi, bool(params.get("hi_open"))


def reference_share(values, params, cache):
    return plain.count_between(values, *bounds(params, plain.dtype(values)))


def join(parts, params):
    return sum(parts)


def compare(answer, expected):
    return {"count_gap": abs(int(answer) - int(expected))}


def work(info, params):
    # two thresholds: a search of two steps and the count
    return roofline.key_work(info, roofline.search_ops(info, 2))
