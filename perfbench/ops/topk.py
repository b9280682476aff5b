"""TOP-K(column): the k largest (or smallest) values, best first:
``alp_tpu_torch.query_topk`` against ``torch.topk`` of the values."""

import alp_tpu_torch
from harness import compare as cmp
from harness import roofline
from reference import plain

SPAN = "engine.query_topk"
NUMBERS = {"ulp_gap": 0}


def call(col, params, device, span):
    with span(SPAN):
        return alp_tpu_torch.query_topk(col, int(params["k"]),
                                        bool(params.get("largest", True)),
                                        device=device)


def key(params):
    return int(params["k"]), bool(params.get("largest", True))


def reference(values, params, cache):
    return plain.topk(values, *key(params))


def compare(answer, expected):
    return {"ulp_gap": cmp.ulp_gap(answer, expected)}


def work(info, params):
    # one read: decode, key, and a compare with the running k-th best
    return roofline.key_work(info, roofline.compare_ops(info))
