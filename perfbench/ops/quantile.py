"""QUANTILE(column, qs), numpy's ``linear`` method:
``alp_tpu_torch.query_quantile`` against the sorted column's
interpolation.  Reads ``engine.LAST_RANK_PASSES`` after each call."""

import alp_tpu_torch
from alp_tpu_torch import engine
from harness import compare as cmp
from harness import roofline
from reference import plain

SPAN = "engine.query_quantile"
NUMBERS = {"ulp_gap": 0}


def call(col, params, device, span):
    with span(SPAN):
        return alp_tpu_torch.query_quantile(col, list(params["q"]),
                                            device=device)


def counters():
    return {"rank_passes": engine.LAST_RANK_PASSES}


def key(params):
    return tuple(float(q) for q in params["q"])


def reference(values, params, cache):
    return plain.quantiles_of(values, key(params), cache)


def compare(answer, expected):
    return {"ulp_gap": cmp.ulp_gap(answer, expected)}


def work(info, params):
    # one read of the column, counting at the ranks: up to two a quantile
    return roofline.key_work(info,
                             roofline.search_ops(info, 2 * len(params["q"])))
