"""Scan: the whole column decoded into a device buffer with its kept plan
(``col.plan(device).run()``), ending at ``torch.cuda.synchronize()``.
Its outputs are as large as the column decoded, so only a sample is kept for the check:
``KEEP = "sample"``.  The check counts the values whose bits differ from
the generated ones."""

import torch

from harness import roofline

SPAN = "plan.run"
NUMBERS = {"values_wrong": 0}
KEEP = "sample"


def call(col, params, device, span):
    with span(SPAN):
        out = col.plan(device).run()
    if out.is_cuda:
        with span("cuda.synchronize"):
            torch.cuda.synchronize(out.device)
    return out


def key(params):
    return ()


def reference(values, params, cache):
    return values


def compare(answer, expected):
    n = expected.numel()
    got = answer.reshape(-1)
    if got.numel() < n or got.dtype != expected.dtype:
        return {"values_wrong": n}
    ints = {8: torch.int64, 4: torch.int32}[expected.element_size()]
    wrong = got[:n].view(ints) != expected.reshape(-1).view(ints)
    return {"values_wrong": int(wrong.sum())}


def work(info, params):
    return roofline.scan_work(info)
