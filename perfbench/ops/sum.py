"""SUM(column), exact: ``alp_tpu_torch.query_sum`` against the reference's
correctly rounded sum."""

import alp_tpu_torch
from harness import compare as cmp
from harness import roofline
from reference import plain

SPAN = "engine.query_sum"
NUMBERS = {"ulp_gap": 0}


def call(col, params, device, span):
    with span(SPAN):
        return alp_tpu_torch.query_sum(col, device=device)


def key(params):
    return ()


def reference(values, params, cache):
    return plain.exact_sum(values)


def compare(answer, expected):
    return {"ulp_gap": cmp.ulp_gap(answer, expected)}


def work(info, params):
    return roofline.sum_work(info)
