"""MEDIAN(column): ``alp_tpu_torch.query_median`` against numpy's median
of the sorted column.  Reads ``engine.LAST_RANK_PASSES`` after each
call."""

import alp_tpu_torch
from alp_tpu_torch import engine
from harness import compare as cmp
from harness import roofline
from reference import plain

SPAN = "engine.query_median"
NUMBERS = {"ulp_gap": 0}


def call(col, params, device, span):
    with span(SPAN):
        return alp_tpu_torch.query_median(col, device=device)


def counters():
    return {"rank_passes": engine.LAST_RANK_PASSES}


def key(params):
    return ()


def reference(values, params, cache):
    return plain.quantiles_of(values, [0.5], cache)[0]


def compare(answer, expected):
    return {"ulp_gap": cmp.ulp_gap(answer, expected)}


def work(info, params):
    return roofline.key_work(info, roofline.search_ops(info, 2))
