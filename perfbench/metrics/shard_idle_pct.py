"""shard_idle_pct: ``device_idle_pct`` with the collectives' kernels
counted as idle: the share of rank 0's traced window (first request's
start to the last one's end) in which no kernel, copy or set of its
requests ran on the device other than a kernel whose name holds ``nccl``
(which spins while it waits for the slowest rank)."""


def collective(name: str) -> bool:
    """A kernel of NCCL's collectives."""
    return "nccl" in name.lower()


def read(run):
    tr = run.trace
    if tr is None or not tr.requests or not tr.device:
        return None
    ops = sorted(op for each in tr.request_ops for op in each
                 if not collective(op[2]))
    lo, hi = tr.window
    return 100.0 * (1.0 - sum(e - s for s, e in tr.merged(ops)) / (hi - lo))
