"""Zstd competitor via a ctypes binding of the system libzstd.

Counterpart of ``alp_tpu/competitors/zstd_codec.py``.  The reference
benchmarks ZSTD_compress at level 3 over rowgroup-sized chunks (102,400
values: publication/source_code/bench_compression_ratio/zstd.cpp:11-12,
level at :64).  This module binds the system libzstd with ctypes; if the
library is absent, ``HAVE_ZSTD`` is False.  Plan snapshots
(``plan_store``) compress their payload with the same binding.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from ..constants import ROWGROUP_SIZE

ROWGROUP_VALUES = ROWGROUP_SIZE  # 102400
ZSTD_LEVEL = 3  # reference zstd.cpp:64

_lib = None


def _load() -> "ctypes.CDLL | None":
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("zstd")
    for cand in ([name] if name else []) + ["libzstd.so.1", "libzstd.so"]:
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_versionNumber.restype = ctypes.c_uint
        lib.ZSTD_versionNumber.argtypes = []
        _lib = lib
        return lib
    return None


HAVE_ZSTD = _load() is not None


def zstd_version() -> str:
    lib = _load()
    if lib is None:
        return "absent"
    v = lib.ZSTD_versionNumber()
    return f"{v // 10000}.{v // 100 % 100}.{v % 100}"


def _compress_chunk(lib, raw: bytes) -> bytes:
    bound = lib.ZSTD_compressBound(len(raw))
    dst = ctypes.create_string_buffer(bound)
    n = lib.ZSTD_compress(dst, bound, raw, len(raw), ZSTD_LEVEL)
    if lib.ZSTD_isError(n):
        raise RuntimeError("ZSTD_compress failed")
    return dst.raw[:n]


def decompress_into(src: bytes, offset: int, dst: int, n_out: int) -> bool:
    """Decompress the zstd frame that fills ``src`` from ``offset`` into
    the ``n_out`` bytes at address ``dst``, without copying ``src``; False
    when it is not a frame of exactly that many bytes."""
    lib = _need_lib()
    at = ctypes.cast(ctypes.c_char_p(src), ctypes.c_void_p).value + offset
    n = lib.ZSTD_decompress(dst, n_out, at, len(src) - offset)
    return not lib.ZSTD_isError(n) and n == n_out


def _need_lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("libzstd not available (check HAVE_ZSTD)")
    return lib


def zstd_bits(data: np.ndarray) -> int:
    """Total compressed bits over rowgroup-sized chunks, level 3 (a short
    tail is compressed as its own smaller chunk; zstd.cpp:44-70)."""
    lib = _need_lib()
    flat = np.ascontiguousarray(data).reshape(-1)
    total = 0
    for off in range(0, flat.size, ROWGROUP_VALUES):
        raw = flat[off:off + ROWGROUP_VALUES].tobytes()
        total += len(_compress_chunk(lib, raw)) * 8
    return total


def zstd_roundtrip(data: np.ndarray) -> int:
    """Compress + decompress + bit-exact validate; returns total bits."""
    lib = _need_lib()
    flat = np.ascontiguousarray(data).reshape(-1)
    total = 0
    for off in range(0, flat.size, ROWGROUP_VALUES):
        raw = flat[off:off + ROWGROUP_VALUES].tobytes()
        blob = _compress_chunk(lib, raw)
        total += len(blob) * 8
        dst = ctypes.create_string_buffer(len(raw))
        if not decompress_into(blob, 0, ctypes.addressof(dst), len(raw)):
            raise RuntimeError("ZSTD_decompress failed")
        if dst.raw != raw:
            raise RuntimeError("zstd round-trip mismatch")
    return total
