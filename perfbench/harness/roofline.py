"""The yardstick of ``roofline_pct``: peaks, and the work a request needs.

A request's least time is the larger of its bytes at the card's memory
bandwidth and its operations at the card's issue rates.  The work is
counted from the column and the query, the same whatever kernels do it:
the compressed column read once and any decoded values written once, and
the operations a value that the algorithm needs, as ``chip_smoke.py``
counts them for its kernels' ``bound_ms`` (copied here: ``SUM_OPS``,
``KEY_OPS``, ``RANK_SEARCH``; ``chip_smoke.py:247-394``).  A request that
a design serves in several passes (a QUANTILE's bisection) is counted as
one read of the column.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# Copied from chip_smoke.py:247-394 (the kernels' bound arithmetic).
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT32_LANES_PER_SM = 64          # Hopper: 4 sub-partitions x 16 INT32 lanes
FP64_LANES_PER_SM = 64           # Hopper: 4 sub-partitions x 16 FP64 lanes
FP32_LANES_PER_SM = 128          # Hopper: 4 sub-partitions x 32 FP32 lanes
# Operations the exact SUM needs a value (32-bit integer operations, a
# 64-bit one counting two): every value its exponent field (2) and the
# test for zero and the specials (2); a nonzero finite value its
# mantissa, e_eff, window and shift, digits and their adds (14 f64); the
# fused decode adds the FOR add and the FACT product (5), the unpack at
# bit width > 0 (4), and two float operations.
SUM_OPS = {  # kernel -> (every value, nonzero finite value, unpack, float)
    "exact_sum_f64": (4, 14, 0, 0), "exact_sum_f32": (4, 11, 0, 0),
    "falp_decode_f64_exact_sum": (9, 14, 4, 2),
    "falp_decode_f32_exact_sum": (6, 11, 2, 2)}
# The decode and key a value: ALP every value (5), its unpack at bw > 0
# (4), two float operations; ALP_RD every value (6: the dictionary read
# and the glue), the right part's unpack at rbw > 0 (4), the dictionary
# index's at lbw > 0 (2); the key (6); a compare (2 for a 64-bit key).
KEY_OPS = {  # f64 -> (ALP every, unpack, RD every, RD right unpack, key,
             #         compare)
    True: (5, 4, 6, 4, 6, 2), False: (2, 2, 4, 2, 3, 1)}
RANK_SEARCH = (1, 1)             # (a compare a search step, the count)

# The card's peaks by ``torch.cuda.get_device_name()``: memory bandwidth
# (NVIDIA's data sheet), SMs and the maximum SM clock, from which the
# INT32, FP64 and FP32 issue rates (SMs x lanes x clock) follow.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": HBM_BYTES_PER_S,
                              "sms": 132, "max_sm_hz": 1.98e9},
}
FORMAT_VECTOR_BYTES = 13   # fac, exp, bit width (1 each), base (8), count (2)
FORMAT_ROWGROUP_BYTES = 20  # scheme, dictionary (8 x 2), size, widths


def rates(device_name: str):
    """(bytes/s, INT32 ops/s, FP64 ops/s, FP32 ops/s) of a card, or
    None."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    issue = peak["sms"] * peak["max_sm_hz"]
    return (peak["hbm_bytes_per_s"], issue * INT32_LANES_PER_SM,
            issue * FP64_LANES_PER_SM, issue * FP32_LANES_PER_SM)


@dataclasses.dataclass(frozen=True)
class ColumnInfo:
    """What a column's work depends on, from its compressed form and its
    values."""
    n_values: int
    value_bytes: int          # 8 for float64, 4 for float32
    compressed_bytes: int     # packed words, exceptions, metadata
    alp_values: int           # values in ALP vectors
    alp_unpacked: int         # ... whose bit width is above 0
    rd_values: int            # values in ALP_RD vectors
    rd_unpacked: int          # ... whose right bit width is above 0
    rd_left_unpacked: int     # ... whose left bit width is above 0
    nonzero_finite: int       # values that are neither 0 nor special

    @property
    def f64(self) -> bool:
        return self.value_bytes == 8


# value width -> (the integer type of its bits, exponent bits, mantissa bits)
_LAYOUT = {8: ("int64", 11, 52), 4: ("int32", 8, 23)}


def column_info(col, values) -> ColumnInfo:
    """``col`` a float64 or float32 ``CompressedColumn`` (its host
    fields), ``values`` its raw values (a tensor of its dtype)."""
    import torch
    width = np.dtype(col.dtype).itemsize
    if width not in _LAYOUT:
        raise TypeError(f"no work model for {np.dtype(col.dtype)} columns")
    n = col.n_values
    per_vec = np.full(col.n_vectors, 1024, np.int64)
    per_vec[-1] = n - (col.n_vectors - 1) * 1024
    rg = np.arange(col.n_vectors) // 100
    rd = col.rg_scheme[rg] == 1          # SCHEME_ALP_RD
    bw = col.bit_width.astype(np.int64)
    rbw = col.rd_right_bw[rg].astype(np.int64)
    lbw = col.rd_left_bw[rg].astype(np.int64)
    words = sum(a.nbytes for a in col.packed)
    words += sum(a.nbytes for a in col.left_packed)
    words += sum(a.nbytes for a in col.exc_values)
    words += sum(a.nbytes for a in col.exc_positions)
    meta = (col.n_vectors * FORMAT_VECTOR_BYTES
            + col.n_rowgroups * FORMAT_ROWGROUP_BYTES)
    int_type, exp_bits, man_bits = _LAYOUT[width]
    bits = values.reshape(-1).view(getattr(torch, int_type))
    special = (1 << exp_bits) - 1
    field = (bits >> man_bits) & special
    nonzero = int(((field != special) & ((bits << 1) != 0)).sum())
    return ColumnInfo(
        n_values=n, value_bytes=width, compressed_bytes=int(words + meta),
        alp_values=int(per_vec[~rd].sum()),
        alp_unpacked=int(per_vec[~rd & (bw > 0)].sum()),
        rd_values=int(per_vec[rd].sum()),
        rd_unpacked=int(per_vec[rd & (rbw > 0)].sum()),
        rd_left_unpacked=int(per_vec[rd & (lbw > 0)].sum()),
        nonzero_finite=nonzero)


def decode_ops(info: ColumnInfo) -> tuple:
    """(integer, float) operations of decoding every value once."""
    every, unpack, rd_every, rd_unpack, _, _ = KEY_OPS[info.f64]
    ints = (info.alp_values * every + info.alp_unpacked * unpack
            + info.rd_values * rd_every + info.rd_unpacked * rd_unpack
            + info.rd_left_unpacked * 2)
    return ints, 2 * info.alp_values


def sum_work(info: ColumnInfo) -> dict:
    """The exact SUM of every value: SUM_OPS's fused decode on ALP values,
    the decode and the plain SUM's every-value work on ALP_RD values."""
    w = 64 if info.f64 else 32
    f_every, digits, f_unpack, flops = \
        SUM_OPS[f"falp_decode_f{w}_exact_sum"]
    s_every = SUM_OPS[f"exact_sum_f{w}"][0]
    _, _, rd_every, rd_unpack, _, _ = KEY_OPS[info.f64]
    ints = (info.alp_values * f_every + info.alp_unpacked * f_unpack
            + info.rd_values * (rd_every + s_every)
            + info.rd_unpacked * rd_unpack + info.rd_left_unpacked * 2
            + info.nonzero_finite * digits)
    return {"bytes": info.compressed_bytes, "int_ops": ints,
            "float_ops": flops * info.alp_values, "f64": info.f64}


def key_work(info: ColumnInfo, per_value: int) -> dict:
    """Decode and key every value, then ``per_value`` more integer
    operations each (the predicate or the search)."""
    ints, flops = decode_ops(info)
    key = KEY_OPS[info.f64][4]
    return {"bytes": info.compressed_bytes,
            "int_ops": ints + info.n_values * (key + per_value),
            "float_ops": flops, "f64": info.f64}


def compare_ops(info: ColumnInfo) -> int:
    """One compare of a key (2 integer operations for a 64-bit key)."""
    return KEY_OPS[info.f64][5]


def search_ops(info: ColumnInfo, thresholds: int) -> int:
    """A counting search over ``thresholds`` keys a value (K15's count)."""
    return (RANK_SEARCH[0] * math.ceil(math.log2(thresholds + 1))
            * compare_ops(info) + RANK_SEARCH[1])


def scan_work(info: ColumnInfo) -> dict:
    """Decode every value once and write it."""
    ints, flops = decode_ops(info)
    return {"bytes": info.compressed_bytes + info.value_bytes * info.n_values,
            "int_ops": ints, "float_ops": flops, "f64": info.f64}


def least_seconds(work: dict, device_name: str, chips: int = 1):
    """The least time of ``work`` on ``chips`` such cards together, or
    None for a card with no entry in ``PEAKS``.  Float operations issue at
    the FP64 rate on a float64 column, at the FP32 rate on a float32
    one."""
    r = rates(device_name)
    if r is None:
        return None
    hbm, int_rate, fp64_rate, fp32_rate = r
    return max(work["bytes"] / (hbm * chips),
               work["int_ops"] / (int_rate * chips),
               work["float_ops"] / ((fp64_rate if work["f64"] else fp32_rate)
                                    * chips))


def summed(shares: list) -> ColumnInfo:
    """The whole column's ``ColumnInfo`` from those of its shares (runs of
    whole rowgroups, compressed apart): every count summed."""
    widths = {s.value_bytes for s in shares}
    if len(widths) != 1:
        raise ValueError(f"shares of other widths: {sorted(widths)}")
    counts = {f.name: sum(getattr(s, f.name) for s in shares)
              for f in dataclasses.fields(ColumnInfo)
              if f.name != "value_bytes"}
    return ColumnInfo(value_bytes=widths.pop(), **counts)
