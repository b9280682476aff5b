"""SUM(v) WHERE lo <= v <= hi, exact: ``alp_tpu_torch.query_filter_sum``.

The bounds are rounded to the column's dtype, and the correctly rounded
sum is given in it (a float32 column rounds the double sum once more),
as the port states.  The work counts the decode, the key and its two compares a value, and no
digits: a bound below what the selected values need."""

import numpy as np

import alp_tpu_torch
from harness import compare as cmp
from harness import roofline
from reference import plain

SPAN = "engine.query_filter_sum"
NUMBERS = {"ulp_gap": 0}


def bounds(params, dtype):
    dt = np.dtype(dtype).type
    return tuple(float(dt(b)) for b in params["range"])


def call(col, params, device, span):
    lo, hi = bounds(params, col.dtype)
    with span(SPAN):
        return alp_tpu_torch.query_filter_sum(col, lo, hi, device=device)


def key(params):
    return tuple(float(b) for b in params["range"])


def reference(values, params, cache):
    dt = plain.dtype(values)
    return np.dtype(dt).type(plain.sum_between(values, *bounds(params, dt)))


def compare(answer, expected):
    return {"ulp_gap": cmp.ulp_gap(answer, expected)}


def work(info, params):
    return roofline.key_work(info, 2 * roofline.compare_ops(info))
