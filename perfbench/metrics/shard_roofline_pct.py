"""shard_roofline_pct: ``roofline_pct`` with the collectives' kernels left
out: the least time of the work the window's requests need
(``harness.roofline``, the whole column's work at the cell's cards'
rates) over rank 0's device-busy time inside their spans, counting no
kernel whose name holds ``nccl``.  An NCCL kernel is busy while it waits
for the slowest rank, so counting it would read the cell too well."""


def collective(name: str) -> bool:
    """A kernel of NCCL's collectives."""
    return "nccl" in name.lower()


def read(run):
    tr = run.trace
    if tr is None or len(tr.requests) != len(run.window.records):
        return None
    if any(s is None for s in run.least_s):
        return None
    busy = sum(e - s for ops in tr.request_ops for s, e in
               tr.merged([op for op in ops if not collective(op[2])]))
    if busy <= 0:
        return None
    return 100.0 * sum(run.least_s) / (busy * 1e-6)
