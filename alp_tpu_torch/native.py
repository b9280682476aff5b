"""ctypes loader for the host engine in ``native/alpcore.cpp``.

The port plans and encodes columns on the host through the same C++
engine the JAX package uses, built from the unchanged source by this
loader of its own.  The library is built with g++ on first use into
``native/.cache/``, under a name keyed by a hash of the source, the flags,
g++'s resolved target and the CPU's feature flags, so a stale or foreign
binary is never loaded.  A build that fails raises ``NativeBuildError``;
there is no other planner to fall back to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import time

import numpy as np

from . import constants as C

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_SRC = _ROOT / "native" / "alpcore.cpp"
_CACHE_DIR = _ROOT / "native" / ".cache"
# -ffp-contract=off: a contracted multiply-add would change the encoder's
# magic-number rounding; -march=native vectorises the encode loop, so the
# cache key includes what "native" means on this host.
_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fopenmp"]

_P = ctypes.c_void_p
_L = ctypes.c_long
_I = ctypes.c_int


class NativeBuildError(RuntimeError):
    """g++ is missing or refused ``native/alpcore.cpp``."""


def _host_key() -> bytes:
    try:
        march = subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"g++ is not usable: {e}") from e
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        flags = ""
    return march.encode() + flags.encode()


@functools.cache
def build() -> tuple[pathlib.Path, float]:
    """Build (or find) the library; returns (path, seconds spent building,
    0.0 when the cached build was current)."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_FLAGS).encode()
        + _host_key()).hexdigest()[:16]
    lib_file = _CACHE_DIR / f"libalpcore-{digest}.so"
    if lib_file.exists():
        return lib_file, 0.0
    _CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_file.with_name(f"{lib_file.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *_FLAGS, "-shared", "-fPIC", "-o", str(tmp),
                        str(_SRC)], check=True, capture_output=True,
                       text=True)
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(
            f"g++ failed on {_SRC.name}:\n{e.stderr}") from e
    except OSError as e:
        raise NativeBuildError(f"g++ is not usable: {e}") from e
    os.replace(tmp, lib_file)
    return lib_file, time.perf_counter() - t0


@functools.cache
def lib() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(build()[0]))
    sigs = {
        "alp_init_f64_multi": [_P, _L, _L, _I, _I, _P, _P, _P,
                               ctypes.c_double, _I, _L, _P, _P, _P],
        "alp_init_f32_multi": [_P, _L, _L, _I, _I, _P, _P, _P, _I,
                               ctypes.c_float, ctypes.c_float, _I, _L,
                               _P, _P, _P],
        "alp_encode_f64_multi": [_P, _L, _P, _P, _I, _I, _P, _P, _P,
                                 ctypes.c_double] + [_P] * 9,
        "alp_encode_f32_multi": [_P, _L, _P, _P, _I, _I, _P, _P, _P, _I,
                                 ctypes.c_float, ctypes.c_float] + [_P] * 9,
        "alp_ffor_ragged_u64": [_P, _P, _P, _P, _P, _L],
        "alp_ffor_ragged_u32": [_P, _P, _P, _P, _P, _L],
    }
    for name, argtypes in sigs.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = None
    return dll


def _p(a: np.ndarray) -> int:
    if not a.flags.c_contiguous:
        raise ValueError("native arrays must be C-contiguous")
    return a.ctypes.data


def init_f64_multi(data: np.ndarray, n_rg: int):
    """Whole-column rowgroup planning: sampling, top-k (e, f) search and
    the ALP / ALP_RD choice.  Returns (schemes [n_rg], combos
    [n_rg, 5, 2], k [n_rg])."""
    tc = C.DOUBLE
    data = np.ascontiguousarray(data, np.float64)
    schemes = np.empty(n_rg, np.int32)
    combos = np.zeros((n_rg, C.MAX_K_COMBINATIONS, 2), np.int32)
    k = np.zeros(n_rg, np.int32)
    lib().alp_init_f64_multi(
        _p(data), len(data), n_rg, C.N_VECTORS_PER_ROWGROUP,
        C.MAX_K_COMBINATIONS, _p(tc.exp_arr), _p(tc.frac_arr),
        _p(tc.fact_arr), tc.magic_number, tc.max_exponent,
        int(tc.rd_size_threshold_limit), _p(schemes), _p(combos), _p(k))
    return schemes, combos, k


def init_f32_multi(data: np.ndarray, n_rg: int):
    """The float twin of :func:`init_f64_multi`."""
    tc = C.FLOAT
    data = np.ascontiguousarray(data, np.float32)
    schemes = np.empty(n_rg, np.int32)
    combos = np.zeros((n_rg, C.MAX_K_COMBINATIONS, 2), np.int32)
    k = np.zeros(n_rg, np.int32)
    lib().alp_init_f32_multi(
        _p(data), len(data), n_rg, C.N_VECTORS_PER_ROWGROUP,
        C.MAX_K_COMBINATIONS, _p(tc.exp_arr), _p(tc.frac_arr),
        _p(tc.fact_arr), len(tc.fact_arr), tc.magic_number,
        float(tc.encoding_upper_limit_pt), tc.max_exponent,
        int(tc.rd_size_threshold_limit), _p(schemes), _p(combos), _p(k))
    return schemes, combos, k


def _encode_multi(fn, vectors, combos_rg, k_rg, tc, extra):
    n = vectors.shape[0]
    out = {
        "fac": np.empty(n, np.uint8), "exp": np.empty(n, np.uint8),
        "bit_width": np.empty(n, np.uint8), "base": np.empty(n, tc.st),
        "encoded": np.empty((n, C.VECTOR_SIZE), tc.st),
        "exc_values": np.empty((n, C.VECTOR_SIZE), tc.pt),
        "exc_positions": np.empty((n, C.VECTOR_SIZE), np.uint16),
        "exc_count": np.empty(n, np.uint16),
        "enc_max": np.empty(n, np.uint64),
    }
    combos_rg = np.ascontiguousarray(combos_rg, np.int32)
    k_rg = np.ascontiguousarray(k_rg, np.int32)
    fn(_p(vectors), n, _p(combos_rg), _p(k_rg), combos_rg.shape[1],
       C.N_VECTORS_PER_ROWGROUP, _p(tc.exp_arr), _p(tc.frac_arr),
       _p(tc.fact_arr), *extra,
       *(_p(out[key]) for key in ("fac", "exp", "bit_width", "base",
                                  "encoded", "exc_values", "exc_positions",
                                  "exc_count", "enc_max")))
    return out


def encode_f64_multi(vectors: np.ndarray, combos_rg: np.ndarray,
                     k_rg: np.ndarray) -> dict:
    """Whole-column ALP encode of [n, 1024] doubles in one native call.

    combos_rg: [n_rg, max_k, 2] int32 (e, f) candidates per rowgroup;
    k_rg: [n_rg] candidate counts.  Returns per-vector metadata, the
    encoded ints (exception slots filled) and the exceptions, dense
    [n, 1024] with ``exc_count`` valid entries per row."""
    tc = C.DOUBLE
    vectors = np.ascontiguousarray(vectors, np.float64)
    return _encode_multi(lib().alp_encode_f64_multi, vectors, combos_rg,
                         k_rg, tc, (tc.magic_number,))


def encode_f32_multi(vectors: np.ndarray, combos_rg: np.ndarray,
                     k_rg: np.ndarray) -> dict:
    """The float twin of :func:`encode_f64_multi`."""
    tc = C.FLOAT
    vectors = np.ascontiguousarray(vectors, np.float32)
    return _encode_multi(lib().alp_encode_f32_multi, vectors, combos_rg,
                         k_rg, tc, (len(tc.fact_arr), tc.magic_number,
                                    float(tc.encoding_upper_limit_pt)))


def _ffor_ragged(fn, encoded, bw, base, ut):
    n = encoded.shape[0]
    lanes = C.VECTOR_SIZE // (np.dtype(ut).itemsize * 8)
    bw = np.ascontiguousarray(bw, np.uint8)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(bw.astype(np.int64) * lanes, out=off[1:])
    flat = np.empty(int(off[-1]), ut)
    fn(_p(np.ascontiguousarray(encoded).view(ut)), _p(flat), _p(bw),
       _p(np.ascontiguousarray(base).view(ut)), _p(off), n)
    return flat, off


def ffor_ragged(encoded: np.ndarray, bw: np.ndarray, base: np.ndarray):
    """FFOR-pack every vector of [n, 1024] int64 at its own bit width into
    one flat u64 buffer; returns (flat words, word offsets [n + 1])."""
    return _ffor_ragged(lib().alp_ffor_ragged_u64, encoded, bw, base,
                        np.uint64)


def ffor_ragged32(encoded: np.ndarray, bw: np.ndarray, base: np.ndarray):
    """The 32-bit twin of :func:`ffor_ragged`."""
    return _ffor_ragged(lib().alp_ffor_ragged_u32, encoded, bw, base,
                        np.uint32)
