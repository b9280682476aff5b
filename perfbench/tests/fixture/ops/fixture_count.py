"""COUNT(*) WHERE lo <= v <= hi on one or several cards, for the
benchmark's tests: each rank counts its share with
``alp_tpu_torch.query_filter_count``, and an all-reduce on the mesh's
group adds the counts, so every rank answers the whole question.

``range`` and ``hi_open`` as ``ops/filter_count.py``.  The share's part
of the reference is its count, and the parts join by their sum.  The
configuration's ``fault`` plants a fault on the last rank: ``disagree``
answers one more than the others; ``kill`` kills the rank's process at
its ``KILL_AFTER``-th call, and ``fail`` makes that call raise once the
counts are joined.
"""

import os
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import alp_tpu_torch
from harness import roofline
from reference import plain

SPAN = "engine.query_filter_count"
NUMBERS = {"count_gap": 0}
KILL_AFTER = 50
_calls = [0]


def bounds(params, dtype):
    dt = np.dtype(dtype).type
    lo, hi = params["range"]
    lo = dt(-np.inf) if lo is None else dt(lo)
    hi = dt(hi)
    if params.get("hi_open"):
        hi = np.nextafter(hi, dt(-np.inf))
    return float(lo), float(hi)


def call(col, params, device, span, ranks=None):
    lo, hi = bounds(params, col.dtype)
    with span(SPAN):
        n = alp_tpu_torch.query_filter_count(col, lo, hi, device=device)
    if ranks is None:
        return n
    fault = (ranks.config.get("fault") or {}).get("kind")
    last = ranks.rank == ranks.world - 1
    _calls[0] += 1
    if fault == "kill" and last and _calls[0] >= KILL_AFTER:
        print(f"planted fault: rank {ranks.rank} kills itself at "
              f"{time.time():.3f}", file=sys.stderr, flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    total = torch.tensor([n], dtype=torch.int64, device=device)
    with span("fixture.all_reduce"):
        dist.all_reduce(total, group=ranks.mesh.get_group())
        n = int(total)
    if fault == "fail" and last and _calls[0] == KILL_AFTER:
        raise RuntimeError("planted fault: this request fails here alone")
    return n + 1 if fault == "disagree" and last else n


def key(params):
    lo, hi = params["range"]
    return lo, hi, bool(params.get("hi_open"))


def reference(values, params, cache):
    return plain.count_between(values, *bounds(params, plain.dtype(values)))


reference_share = reference


def join(parts, params):
    return sum(parts)


def compare(answer, expected):
    return {"count_gap": abs(int(answer) - int(expected))}


def work(info, params):
    return roofline.key_work(info, roofline.search_ops(info, 2))
