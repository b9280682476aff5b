"""SUM(column) over the cards of a cell on several cards, exact:
``alp_tpu_torch.parallel.share_sum`` of the rank's resident share (its
K5-K8 totals, gathered over the mesh and joined exactly on every rank)
against the correctly rounded sum of the joined shares' exact totals.

A program without resident shares fails here at once, as the op loads."""

from alp_tpu_torch.parallel import share_sum

from harness import compare as cmp
from harness import roofline, shares
from reference import joined

SPAN = "parallel.sum"
NUMBERS = {"ulp_gap": 0}


def call(col, params, device, span, ranks):
    sh = shares.of(col, ranks)
    with span(SPAN):
        return share_sum(sh)


def key(params):
    return ()


def reference_share(values, params, cache):
    return joined.total_part(values, cache=cache)


def join(parts, params):
    return joined.sum_of(parts)


def compare(answer, expected):
    return {"ulp_gap": cmp.ulp_gap(answer, expected)}


def work(info, params):
    return roofline.sum_work(info)
