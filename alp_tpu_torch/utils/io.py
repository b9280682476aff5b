"""Dataset readers (CSV one-value-per-line; raw little-endian binary).

Counterpart of ``alp_tpu/utils/io.py``: the same arrays from the same
files.

Mirrors reference data/include/data.hpp:16-72 (binary preferred over CSV)
and the CSV parsing of test/test_alp_sample.cpp:125-134 (std::stod /
std::stof per line).
"""

from __future__ import annotations

import numpy as np

from .datasets import Column


def read_csv(path, dtype) -> np.ndarray:
    dt = np.dtype(dtype)
    # stream >> string tokenizes on whitespace; std::stod/stof ignore
    # trailing junk (some files carry trailing commas, e.g. avx512dq.csv).
    values = [tok.rstrip(",") for tok in open(path).read().split()]
    if dt == np.float64:
        return np.array([float(v) for v in values], dtype=np.float64)
    # std::stof parses the decimal directly to float; numpy's f32 string
    # parser matches it (single rounding).
    return np.array(values, dtype=np.float32)


def read_binary(path, dtype) -> np.ndarray:
    return np.fromfile(path, dtype=np.dtype(dtype))


def mmap_binary(path, dtype) -> np.ndarray:
    """Memory-map a raw binary column (reference test/include/test/
    mapper.hpp:14-24): zero-copy read-only view, paged on demand — the
    right reader for full-corpus files larger than RAM."""
    return np.memmap(path, dtype=np.dtype(dtype), mode="r")


def read_column(column: Column, prefer_binary: bool = True) -> np.ndarray:
    """Load a column's data; binary preferred when present (data.hpp:16)."""
    if prefer_binary and column.binary_path is not None:
        return read_binary(column.binary_path, column.dtype)
    if column.csv_path is not None and column.csv_path.exists():
        return read_csv(column.csv_path, column.dtype)
    raise FileNotFoundError(f"no data found for column {column.name}")


def read_first_vector(column: Column) -> np.ndarray:
    """First 1024 values from the CSV sample (test_alp_sample.cpp:114-134)."""
    data = read_csv(column.csv_path, column.dtype)
    return data[:1024]
