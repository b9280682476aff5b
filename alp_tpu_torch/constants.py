"""ALP constants and fixed geometry, per floating-point type.

The port's own copy of the constant tables of the ALP reference library
(reference include/alp/constants.hpp:10-278 and include/alp/config.hpp:9-28).
The values are algorithm facts (powers of ten, IEEE-754 masks, cost-model
sizes) and must match the reference bit for bit: the port's blobs are held
byte-identical to the JAX package's, and its decoded values bit-identical.

Plain Python and NumPy scalars and arrays: the host planner, the byte format
and the decode plan read them, and the plan hands per-vector FACT/FRAC
values to the kernels.
"""

from __future__ import annotations

import dataclasses
import numpy as np

# ---------------------------------------------------------------------------
# Fixed geometry (reference include/alp/config.hpp:9-28)
# ---------------------------------------------------------------------------

VECTOR_SIZE = 1024
N_VECTORS_PER_ROWGROUP = 100
ROWGROUP_SIZE = N_VECTORS_PER_ROWGROUP * VECTOR_SIZE
ROWGROUP_VECTOR_SAMPLES = 8
# Integer division chain, exactly as the reference computes it:
# (102400 / 8) / 1024 == 12 (12800 // 1024).
ROWGROUP_SAMPLES_JUMP = ((ROWGROUP_SIZE // ROWGROUP_VECTOR_SAMPLES)
                         // VECTOR_SIZE)
SAMPLES_PER_VECTOR = 32
MAX_K_COMBINATIONS = 5
CUTTING_LIMIT = 16
MAX_RD_DICT_BIT_WIDTH = 3
MAX_RD_DICTIONARY_SIZE = 1 << MAX_RD_DICT_BIT_WIDTH

# ---------------------------------------------------------------------------
# Scheme tags and global scalar constants (reference constants.hpp:10-25)
# ---------------------------------------------------------------------------

SCHEME_INVALID = 0
SCHEME_ALP_RD = 1
SCHEME_ALP = 2

SAMPLING_EARLY_EXIT_THRESHOLD = 2
# Largest double that is guaranteed castable to int64: 2^63 - 1024.
ENCODING_UPPER_LIMIT = 9223372036854774784.0
ENCODING_LOWER_LIMIT = -9223372036854774784.0
DICTIONARY_ELEMENT_SIZE_BYTES = 2
RD_EXCEPTION_POSITION_SIZE = 16
EXCEPTION_POSITION_SIZE = 16
RD_EXCEPTION_SIZE = 16


def _pow10_f64(i: int) -> float:
    """Correctly-rounded double for the decimal literal 1e<i>.

    Python float literals are correctly rounded, exactly like C++ double
    literals, so float(f"1e{i}") reproduces the reference EXP/FRAC tables.
    """
    return float(f"1e{i}")


@dataclasses.dataclass(frozen=True)
class TypeConstants:
    """Per-precision constant tables (reference Constants<double|float>)."""

    pt: np.dtype          # floating point type (f64 / f32)
    ut: np.dtype          # unsigned integer of same width
    st: np.dtype          # signed integer of same width
    max_exponent: int
    magic_number: float   # 2^52+2^51 (double) or 2^23+2^22 (float)
    exception_size: int   # bits per stored exception value
    rd_size_threshold_limit: int
    sign_bit_mask: int    # mask of everything except the sign bit
    exponential_bits_mask: int
    negative_zero: int
    exp_arr: np.ndarray   # 10^i as PT   (indexed by exponent idx)
    frac_arr: np.ndarray  # 10^-i as PT  (indexed by factor/exponent idx)
    fact_arr: np.ndarray  # 10^i as ST   (indexed by factor idx)

    @property
    def exact_type_bit_size(self) -> int:
        return np.dtype(self.ut).itemsize * 8

    @property
    def encoding_upper_limit_pt(self):
        """ENCODING_UPPER_LIMIT converted to PT (used to replace specials)."""
        return self.pt.type(ENCODING_UPPER_LIMIT)

    @property
    def int_min(self) -> int:
        return int(np.iinfo(self.st).min)

    @property
    def int_max(self) -> int:
        return int(np.iinfo(self.st).max)


DOUBLE = TypeConstants(
    pt=np.dtype(np.float64),
    ut=np.dtype(np.uint64),
    st=np.dtype(np.int64),
    max_exponent=18,
    # static_cast<double>(0x0018000000000000) == 2^52 + 2^51
    magic_number=float(0x0018000000000000),
    exception_size=64,
    rd_size_threshold_limit=48 * SAMPLES_PER_VECTOR,
    sign_bit_mask=0x7FFFFFFFFFFFFFFF,
    exponential_bits_mask=0x7FF0000000000000,
    negative_zero=0x8000000000000000,
    exp_arr=np.array([_pow10_f64(i) for i in range(24)], dtype=np.float64),
    frac_arr=np.array([_pow10_f64(-i) for i in range(21)], dtype=np.float64),
    fact_arr=np.array([10**i for i in range(19)], dtype=np.int64),
)

FLOAT = TypeConstants(
    pt=np.dtype(np.float32),
    ut=np.dtype(np.uint32),
    st=np.dtype(np.int32),
    max_exponent=10,
    magic_number=12582912.0,  # 2^23 + 2^22
    exception_size=32,
    rd_size_threshold_limit=22 * SAMPLES_PER_VECTOR,
    sign_bit_mask=0x7FFFFFFF,
    exponential_bits_mask=0x7F800000,
    negative_zero=0x80000000,
    # C++ float literals round the decimal string directly to f32; rounding
    # the (correctly-rounded) f64 value to f32 gives the same result for
    # every power of ten in range (verified in tests/test_constants.py).
    exp_arr=np.array([_pow10_f64(i) for i in range(11)], dtype=np.float32),
    frac_arr=np.array([_pow10_f64(-i) for i in range(11)], dtype=np.float32),
    fact_arr=np.array([10**i for i in range(10)], dtype=np.int32),
)


def constants_for(dtype) -> TypeConstants:
    dt = np.dtype(dtype)
    if dt == np.float64:
        return DOUBLE
    if dt == np.float32:
        return FLOAT
    raise TypeError(f"ALP supports float32/float64, got {dt}")
