"""Exact SUM and MEAN of a compressed column on a device.

Counterpart of the SUM path of ``alp_tpu/engine.py`` (``query_sum``,
``query_mean``, ``_finish_sum``, ``_f64_fixed``/``_f32_fixed``,
``make_exact_sum_step``).  A finite value is ``m' * 2^(e_eff - B)`` (B =
1075 for f64, 150 for f32); the kernels add the signed 32-bit digits of
the integer ``m' << e_eff`` into int64 windows over the whole exponent
range and count NaN, +Inf and -Inf apart.  The host joins the windows
with Python integers and rounds once, so ``query_sum`` equals
``math.fsum`` bit for bit and ``query_mean`` is the exact rational
``sum / n`` rounded once.

Per column, ``exact_sum_totals(plan)`` runs on the plan's device:

* every ALP bucket goes through K7/K8, the decode fused with the sum; the
  kernel writes each vector's true exception bits in and skips the pad of
  a partial last vector, so no decoded value reaches device memory and no
  correction is left for the host;
* the ALP_RD buckets decode with K3/K4 into one compact scratch, their
  exceptions are scattered in, and K5/K6 sum the scratch.

The kernels add into int64 ``[W + 3]`` totals, one for each run of fewer
than 2^31 values (one run for any column below that size), which cross to
the host once; the host joins the runs as Python integers, so a column
has no size limit of its own.  The plan comes from
``CompressedColumn.plan(device)``, built at the first query and kept, as
the JAX package keeps its own.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

from . import constants as C
from .kernels import exact_sum as kes
from .kernels.decode import VECTOR_SIZE, resolve_device

# value dtype -> B, the power of two of the fixed-point scale
_SCALE = {np.dtype(np.float64): 1075, np.dtype(np.float32): 150}


def query_sum(col, device=None) -> float:
    """SUM(column), correctly rounded: bit-identical to ``math.fsum`` of
    the column's values.  NaN, or +Inf with -Inf, gives NaN; an empty
    column gives 0.0.  ``device=None`` means ``"cuda"`` and raises when no
    card is present; ``device="cpu"`` runs the kernels' plain versions."""
    dev = resolve_device(device)
    if col.n_values == 0:
        return 0.0
    return _finish_sum(*_sum_raw(col, dev))


def query_mean(col, device=None) -> float:
    """MEAN(column), correctly rounded: the exact rational ``sum / n``
    rounded once (one rounding fewer than ``math.fsum(x) / n``).  An empty
    column gives NaN."""
    dev = resolve_device(device)
    if col.n_values == 0:
        return float("nan")
    total, nan_c, pinf, ninf, scale = _sum_raw(col, dev)
    if nan_c or pinf or ninf:
        return _finish_sum(total, nan_c, pinf, ninf, scale)
    if total == 0:
        return 0.0
    return float(Fraction(total, col.n_values << scale))


@dataclasses.dataclass(frozen=True)
class SumCall:
    """One SUM kernel call of a plan: the kernel's name (a key of
    ``exact_sum.LAUNCHES``), its wrapper's positional arguments, the real
    vector id of each row it sums, and the bit width of its packed words
    (0 for decoded bits)."""
    kernel: str
    args: tuple
    rows: torch.Tensor
    bw: int

    def launch(self, out: torch.Tensor) -> torch.Tensor:
        """The kernel (or, on a CPU tensor, its plain version) added into
        ``out``."""
        return kes.KERNELS[self.kernel][0](*self.args, out=out)

    def plain(self) -> torch.Tensor:
        """The plain version's totals on the same arguments."""
        return kes.KERNELS[self.kernel][1](*self.args)

    def split(self, max_rows: int) -> list:
        """The call cut into calls of at most ``max_rows`` rows each (its
        per-row arguments sliced; the rest shared)."""
        n = self.rows.shape[0]
        if n <= max_rows:
            return [self]
        per_row = _PER_ROW_ARGS[self.kernel]
        return [SumCall(self.kernel,
                        tuple(a[lo:lo + max_rows] if i in per_row else a
                              for i, a in enumerate(self.args)),
                        self.rows[lo:lo + max_rows], self.bw)
                for lo in range(0, n, max_rows)]


# kernel -> positions of its row-indexed arguments: K5/K6 (bits, vec, ...),
# K7/K8 (packed, bw, base, fact, frac, rows, ...)
_PER_ROW_ARGS = {"exact_sum_f64": (0, 1), "exact_sum_f32": (0, 1),
                 "falp_decode_f64_exact_sum": (0, 2, 3, 4, 5),
                 "falp_decode_f32_exact_sum": (0, 2, 3, 4, 5)}


def sum_calls(plan) -> list:
    """The SUM kernel calls of a plan, in launch order: K7/K8 for each ALP
    bucket, then K5/K6 over the ALP_RD vectors, which this decodes (K3/K4)
    into the plan's compact scratch."""
    width = "f64" if plan.f64 else "f32"
    calls = [SumCall(f"falp_decode_{width}_exact_sum",
                     (b.args[0], b.bw, *b.args[1:], b.rows, plan.exc_ptr,
                      plan.exc_index, plan.exc_bits, plan.n_values),
                     b.rows, b.bw)
             for b in plan.buckets if b.scheme == C.SCHEME_ALP]
    if any(b.scheme == C.SCHEME_ALP_RD for b in plan.buckets):
        scratch, vec = plan.decode_rd()
        calls.append(SumCall(f"exact_sum_{width}",
                             (scratch, vec, plan.n_values), vec, 0))
    return calls


def exact_sum_totals(plan, run_values: int = kes.MAX_VALUES
                     ) -> torch.Tensor:
    """The steady-state device part of the SUM: the int64 [runs, W + 3]
    totals of a plan (W windows, then the NaN, +Inf and -Inf counts), on
    the plan's device, with no host join and no synchronise.  Each row is
    the total of a run of fewer than ``run_values`` values (whole vectors,
    pad included), so no int64 total can overflow; a column of fewer than
    2^31 values has one row.  The rows add up as integers
    (``join_totals``)."""
    max_rows = max(1, (run_values - 1) // VECTOR_SIZE)
    runs = [kes.totals(plan.bits_dtype, plan.device)]
    used = 0
    for call in sum_calls(plan):
        for part in call.split(max_rows):
            n = part.rows.shape[0]
            if used + n > max_rows:
                runs.append(kes.totals(plan.bits_dtype, plan.device))
                used = 0
            part.launch(runs[-1])
            used += n
    return torch.stack(runs)


def join_totals(totals: list, dtype) -> tuple:
    """(total_int, nan, pinf, ninf, B): the host join of a column's totals
    (``exact_sum_totals(plan).tolist()``, or one total row), ``total_int =
    sum over rows and w of totals[r][w] << 32 w`` = the column's exact sum
    times 2^B."""
    rows = totals if totals and isinstance(totals[0], list) else [totals]
    W = len(rows[0]) - 3
    total = sum(int(t) << (32 * w) for row in rows
                for w, t in enumerate(row[:W]) if t)
    counts = [sum(int(row[W + i]) for row in rows) for i in range(3)]
    return (total, *counts, _SCALE[np.dtype(dtype)])


def _sum_raw(col, dev) -> tuple:
    plan = col.plan(dev)
    return join_totals(exact_sum_totals(plan).tolist(), col.dtype)


def _finish_sum(total: int, nan_c: int, pinf: int, ninf: int,
                scale: int) -> float:
    """Round the exact sum ``total / 2^scale`` once (engine.py:117-128)."""
    if nan_c or (pinf and ninf):
        return float("nan")
    if pinf:
        return float("inf")
    if ninf:
        return float("-inf")
    if total == 0:
        return 0.0
    return float(Fraction(total, 1 << scale))


def _f64_fixed(bits: int):
    """Host mirror of one f64 value's contribution: (signed ``m' <<
    e_eff``, class), class 0 finite, 1 NaN, 2 +Inf, 3 -Inf."""
    e = (bits >> 52) & 0x7FF
    m = bits & ((1 << 52) - 1)
    s = bits >> 63
    if e == 2047:
        return 0, (1 if m else (3 if s else 2))
    v = (m | (1 << 52) if e else m) << max(e, 1)
    return (-v if s else v), 0


def _f32_fixed(bits: int):
    """f32 twin of :func:`_f64_fixed` (scale 2^-150)."""
    e = (bits >> 23) & 0xFF
    m = bits & ((1 << 23) - 1)
    s = bits >> 31
    if e == 255:
        return 0, (1 if m else (3 if s else 2))
    v = (m | (1 << 23) if e else m) << max(e, 1)
    return (-v if s else v), 0


def host_sum_raw(values: np.ndarray) -> tuple:
    """(total_int, nan, pinf, ninf, B) of a host array through the
    per-value mirror: the reference the tests hold the windows against."""
    values = np.ascontiguousarray(values)
    f64 = values.dtype == np.float64
    fixed = _f64_fixed if f64 else _f32_fixed
    total, counts = 0, [0, 0, 0, 0]
    for b in values.view(np.uint64 if f64 else np.uint32).tolist():
        v, cls = fixed(b)
        total += v
        counts[cls] += 1
    return total, counts[1], counts[2], counts[3], _SCALE[values.dtype]
