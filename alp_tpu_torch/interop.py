"""Carry a column across from the JAX package without importing it.

Two bridges lead from an ``alp_tpu`` column to the port: its ``ALPT``
bytes (``CompressedColumn.from_bytes``) and its fields.
:func:`column_from_arrays` takes the second: the NumPy fields of any
column with the same layout, such as ``dataclasses.asdict`` of an
``alp_tpu.container.CompressedColumn``, and builds the port's column.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .container import CompressedColumn

_FIELDS = [f.name for f in dataclasses.fields(CompressedColumn)]
_RAGGED = ("packed", "left_packed", "exc_values", "exc_positions")


def column_from_arrays(fields: dict) -> CompressedColumn:
    """Build a port column from a column's fields (NumPy arrays; the four
    ragged payloads as lists of per-vector arrays).  Keys the port does not
    know (such as a cached plan) are ignored; a missing one raises."""
    missing = [k for k in _FIELDS if k not in fields and k != "enc_max"]
    if missing:
        raise KeyError(f"column fields missing: {missing}")
    kw = {}
    for name in _FIELDS:
        val = fields.get(name)
        if name in _RAGGED:
            val = [np.asarray(p) for p in val]
        elif name == "dtype":
            val = np.dtype(val)
        elif name in ("n_values", "n_vectors"):
            val = int(val)
        elif val is not None:
            val = np.asarray(val)
        kw[name] = val
    return CompressedColumn(**kw)
