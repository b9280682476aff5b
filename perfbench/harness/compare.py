"""How an answer is held against the reference's: by bits.

``ulp_gap`` is the distance of two floats in units in the last place,
counted along the IEEE-754 order (+0.0 and -0.0 are one point; two NaNs
agree; a NaN against a number, or arrays of other lengths, read
``FAR``).  An exact answer has the gap 0.
"""

from __future__ import annotations

import struct

import numpy as np

FAR = 1 << 64


def _ordered(x: float) -> int:
    bits = struct.unpack("<q", struct.pack("<d", float(x)))[0]
    return bits if bits >= 0 else -(bits & 0x7FFF_FFFF_FFFF_FFFF)


def ulp_gap(a, b) -> int:
    """The largest gap between the floats of ``a`` and ``b`` (scalars or
    equal-length sequences)."""
    a = np.atleast_1d(np.asarray(a, np.float64))
    b = np.atleast_1d(np.asarray(b, np.float64))
    if a.shape != b.shape:
        return FAR
    gap = 0
    for x, y in zip(a.tolist(), b.tolist()):
        if x != x or y != y:
            if not (x != x and y != y):
                return FAR
            continue
        gap = max(gap, abs(_ordered(x) - _ordered(y)))
    return gap
