"""MEAN(column) over the cards of a cell on several cards, exact:
``alp_tpu_torch.parallel.share_mean`` of the rank's resident share (the
shares' K5-K8 totals gathered and joined, over the whole column's count,
rounded once) against the joined shares' exact sum over their count of
values, rounded once.

A program without resident shares fails here at once, as the op loads."""

from alp_tpu_torch.parallel import share_mean

from harness import compare as cmp
from harness import roofline, shares
from reference import joined

SPAN = "parallel.mean"
NUMBERS = {"ulp_gap": 0}


def call(col, params, device, span, ranks):
    sh = shares.of(col, ranks)
    with span(SPAN):
        return share_mean(sh)


def key(params):
    return ()


def reference_share(values, params, cache):
    return joined.total_part(values, cache=cache)


def join(parts, params):
    return joined.mean_of(parts)


def compare(answer, expected):
    return {"ulp_gap": cmp.ulp_gap(answer, expected)}


def work(info, params):
    return roofline.sum_work(info)
