"""SUM(v) WHERE lo <= v <= hi over the cards of a cell on several cards,
exact: ``alp_tpu_torch.parallel.share_filter_sum`` of the rank's resident
share (each share's K5-K8 totals over the key range, gathered and joined
exactly) against the correctly rounded sum of the joined shares' exact
totals of the selected values, in the column's dtype.

The bounds are rounded to the column's dtype, as ``ops/filter_sum.py``;
the work counts the decode, the key and its two compares a value.

A program without resident shares fails here at once, as the op loads."""

import numpy as np
from alp_tpu_torch.parallel import share_filter_sum

from harness import compare as cmp
from harness import roofline, shares
from reference import joined, plain

SPAN = "parallel.filter_sum"
NUMBERS = {"ulp_gap": 0}


def bounds(params, dtype):
    dt = np.dtype(dtype).type
    return tuple(float(dt(b)) for b in params["range"])


def call(col, params, device, span, ranks):
    sh = shares.of(col, ranks)
    lo, hi = bounds(params, sh.dtype)
    with span(SPAN):
        return share_filter_sum(sh, lo, hi)


def key(params):
    return tuple(float(b) for b in params["range"])


def reference_share(values, params, cache):
    dt = plain.dtype(values)
    mask = plain.between(values, *bounds(params, dt))
    return joined.total_part(values, mask), dt.str


def join(parts, params):
    return np.dtype(parts[0][1]).type(joined.sum_of([p for p, _ in parts]))


def compare(answer, expected):
    return {"ulp_gap": cmp.ulp_gap(answer, expected)}


def work(info, params):
    return roofline.key_work(info, 2 * roofline.compare_ops(info))
