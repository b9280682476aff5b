"""ctypes loader for the host engines in ``native/``.

The port plans, encodes and decodes columns on the host through the same
C++ engine the JAX package uses (``native/alpcore.cpp``: the planner, the
encoder, FFOR, and the falp and ALP_RD decoders, OpenMP over vectors, that
``container.decompress_host`` calls), and times the
competitor codecs through the same C++ codecs (``native/competitors.cpp``:
Gorillas, Chimp, Chimp128, Patas and PDE, one core a stream, OpenMP over
chunks), each built from its unchanged source by this loader of its own.
A library is built with g++ on first use into ``native/.cache/``, under a
name keyed by a hash of the source, the flags, g++'s resolved target and
the CPU's feature flags, so a stale or foreign binary is never loaded.  A
build that fails raises ``NativeBuildError``; there is nothing to fall
back to.
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
_SRC_COMPETITORS = _ROOT / "native" / "competitors.cpp"
_CACHE_DIR = _ROOT / "native" / ".cache"
# -ffp-contract=off: a contracted multiply-add would change the encoder's
# magic-number rounding; -march=native vectorises the encode loop, so the
# cache key includes what "native" means on this host.
_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fopenmp"]

_P = ctypes.c_void_p
_L = ctypes.c_long
_I = ctypes.c_int
_UINT = {16: ctypes.c_uint16, 32: ctypes.c_uint32, 64: ctypes.c_uint64}


class NativeBuildError(RuntimeError):
    """g++ is missing or refused a source of ``native/``."""


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
def _build(src: pathlib.Path) -> tuple[pathlib.Path, float]:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(_FLAGS).encode()
        + _host_key()).hexdigest()[:16]
    lib_file = _CACHE_DIR / f"lib{src.stem}-{digest}.so"
    if lib_file.exists():
        return lib_file, 0.0
    _CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_file.with_name(f"{lib_file.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *_FLAGS, "-shared", "-fPIC", "-o", str(tmp),
                        str(src)], check=True, capture_output=True,
                       text=True)
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(
            f"g++ failed on {src.name}:\n{e.stderr}") from e
    except OSError as e:
        raise NativeBuildError(f"g++ is not usable: {e}") from e
    os.replace(tmp, lib_file)
    return lib_file, time.perf_counter() - t0


def build() -> tuple[pathlib.Path, float]:
    """Build (or find) the host engine; returns (path, seconds spent
    building, 0.0 when the cached build was current)."""
    return _build(_SRC)


def build_competitors() -> tuple[pathlib.Path, float]:
    """Build (or find) the competitor codecs, as :func:`build`."""
    return _build(_SRC_COMPETITORS)


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
        # the host decode engine and the per-bucket FFOR of one bit width
        "alp_falp_f64": [_P] * 7 + [_I],
        "alp_falp_f32": [_P] * 7 + [_I],
        "alp_rd_decode_f64": [_P, _P, _P, _P, _I, _I, _P, _I],
        "alp_rd_decode_f32": [_P, _P, _P, _P, _I, _I, _P, _I],
        "alp_ffor_u64_pv": [_P, _P, _I, _P, _I],
        "alp_init_f64": [_P, _L, _L, _P, _P, _P, ctypes.c_double, _I, _L,
                         _P, _P],
        "alp_encode_f64": [_P, _I, _P, _I, _P, _P, _P,
                           ctypes.c_double] + [_P] * 8,
    }
    for bits, ct in _UINT.items():
        for op in ("ffor", "unffor"):
            sigs[f"alp_{op}_u{bits}"] = [_P, _P, _I, ct, _I]
    for name, argtypes in sigs.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = _I if name == "alp_init_f64" else None
    return dll


def _p(a: np.ndarray) -> int:
    """The address of ``a``'s data.  The caller keeps ``a`` alive until
    the native call returns: a temporary would be freed at once."""
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
    encoded = np.ascontiguousarray(encoded).view(ut)
    base = np.ascontiguousarray(base).view(ut)
    fn(_p(encoded), _p(flat), _p(bw), _p(base), _p(off), n)
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


def ffor(values: np.ndarray, bw: int, base) -> np.ndarray:
    """FFOR-pack [n, 1024] unsigned ints (u16, u32 or u64) at one bit
    width and base: [n, bw * L] words in the FastLanes layout."""
    values = np.ascontiguousarray(values)
    ut = values.dtype
    bits = ut.itemsize * 8
    out = np.zeros((values.shape[0], bw * (C.VECTOR_SIZE // bits)), ut)
    getattr(lib(), f"alp_ffor_u{bits}")(_p(values), _p(out), int(bw),
                                        int(base), values.shape[0])
    return out


def ffor_pv(values: np.ndarray, bw: int, bases: np.ndarray) -> np.ndarray:
    """FFOR-pack [n, 1024] 64-bit ints at one bit width, each vector with
    its own base: [n, bw * 16] u64 words."""
    values = np.ascontiguousarray(values).view(np.uint64)
    bases = np.ascontiguousarray(bases).view(np.uint64)
    out = np.zeros((values.shape[0], bw * 16), np.uint64)
    lib().alp_ffor_u64_pv(_p(values), _p(out), int(bw), _p(bases),
                          values.shape[0])
    return out


def unffor(packed: np.ndarray, bw: int, base, ut) -> np.ndarray:
    """The inverse of :func:`ffor`: [n, bw * L] words -> [n, 1024] ``ut``."""
    ut = np.dtype(ut)
    packed = np.ascontiguousarray(packed, ut)
    out = np.empty((packed.shape[0], C.VECTOR_SIZE), ut)
    getattr(lib(), f"alp_unffor_u{ut.itemsize * 8}")(
        _p(packed), _p(out), int(bw), int(base), packed.shape[0])
    return out


def rd_decode(right_packed: np.ndarray, left_packed: np.ndarray,
              dicts: np.ndarray, dict_size: np.ndarray, rbw: int,
              lbw: int, ut) -> np.ndarray:
    """ALP_RD decode of one (right bw, left bw) bucket of n vectors:
    [n, rbw * L] right words, [n, lbw * 64] u16 dictionary-index words
    and [n, 8] u16 dictionaries -> [n, 1024] glued bits of ``ut``, before
    the exceptions are written in (an index is clamped to
    dict_size - 1)."""
    ut = np.dtype(ut)
    # every converted copy is bound to a name: it must outlive the call
    args = (np.ascontiguousarray(right_packed, ut),
            np.ascontiguousarray(left_packed, np.uint16),
            np.ascontiguousarray(dicts, np.uint16),
            np.ascontiguousarray(dict_size, np.int32))
    n = args[0].shape[0]
    out = np.empty((n, C.VECTOR_SIZE), ut)
    fn = (lib().alp_rd_decode_f64 if ut.itemsize == 8
          else lib().alp_rd_decode_f32)
    fn(*map(_p, args), int(rbw), int(lbw), _p(out), n)
    return out


def _falp(fn, tc, packed_flat, offsets, bws, bases, facts, fracs, out):
    n = len(bws)
    if out is None:
        out = np.empty((n, C.VECTOR_SIZE), tc.pt)
    if out.shape != (n, C.VECTOR_SIZE) or out.dtype != tc.pt:
        raise ValueError(f"out must be {np.dtype(tc.pt).name} "
                         f"[{n}, {C.VECTOR_SIZE}]")
    args = [np.ascontiguousarray(a, dt) for a, dt in (
        (packed_flat, tc.ut), (offsets, np.int32), (bws, np.uint8),
        (bases, tc.st), (facts, tc.st), (fracs, tc.pt))]
    fn(*map(_p, args), _p(out), n)
    return out


def falp_f64(packed_flat: np.ndarray, offsets: np.ndarray, bws: np.ndarray,
             bases: np.ndarray, facts: np.ndarray, fracs: np.ndarray,
             out: np.ndarray | None = None) -> np.ndarray:
    """ALP decode of n vectors of mixed bit widths in one call (OpenMP
    over the vectors above 32): vector i's words start at ``offsets[i]``
    of ``packed_flat``; it is unpacked at ``bws[i]`` around ``bases[i]``,
    multiplied by ``facts[i]`` and by ``fracs[i]``.  Decodes into ``out``
    (f64 [n, 1024], C-contiguous) when given; returns it."""
    return _falp(lib().alp_falp_f64, C.DOUBLE, packed_flat, offsets, bws,
                 bases, facts, fracs, out)


def falp_f32(packed_flat: np.ndarray, offsets: np.ndarray, bws: np.ndarray,
             bases: np.ndarray, facts: np.ndarray, fracs: np.ndarray,
             out: np.ndarray | None = None) -> np.ndarray:
    """The float twin of :func:`falp_f64` (int32 bases and facts, float32
    fracs)."""
    return _falp(lib().alp_falp_f32, C.FLOAT, packed_flat, offsets, bws,
                 bases, facts, fracs, out)


def init_f64(data: np.ndarray, offset: int):
    """Planning of the rowgroup at ``offset`` of ``data``: sampling, top-k
    (e, f) search and the ALP / ALP_RD choice.  Returns (scheme, combos
    [max(k, 1), 2] int32, k)."""
    tc = C.DOUBLE
    data = np.ascontiguousarray(data, np.float64)
    combos = np.zeros((C.MAX_K_COMBINATIONS, 2), np.int32)
    k = np.zeros(1, np.int32)
    scheme = lib().alp_init_f64(
        _p(data), len(data), int(offset), _p(tc.exp_arr), _p(tc.frac_arr),
        _p(tc.fact_arr), tc.magic_number, tc.max_exponent,
        int(tc.rd_size_threshold_limit), _p(combos), _p(k))
    return scheme, combos[:max(int(k[0]), 1)], int(k[0])


def encode_f64(vectors: np.ndarray, combos: np.ndarray) -> dict:
    """ALP encode of [n, 1024] doubles sharing the candidates ``combos``
    ([k, 2] int32 (e, f)).  Returns the per-vector metadata, the encoded
    ints (exception slots filled) and the exceptions, dense [n, 1024] with
    ``exc_count`` valid entries a row."""
    tc = C.DOUBLE
    vectors = np.ascontiguousarray(vectors, np.float64)
    combos = np.ascontiguousarray(combos, np.int32)
    n = vectors.shape[0]
    out = {
        "fac": np.empty(n, np.uint8), "exp": np.empty(n, np.uint8),
        "bit_width": np.empty(n, np.uint8), "base": np.empty(n, np.int64),
        "encoded": np.empty((n, C.VECTOR_SIZE), np.int64),
        "exc_values": np.empty((n, C.VECTOR_SIZE), np.float64),
        "exc_positions": np.empty((n, C.VECTOR_SIZE), np.uint16),
        "exc_count": np.empty(n, np.uint16),
    }
    lib().alp_encode_f64(
        _p(vectors), n, _p(combos), combos.shape[0], _p(tc.exp_arr),
        _p(tc.frac_arr), _p(tc.fact_arr), tc.magic_number,
        *(_p(a) for a in out.values()))
    return out


# ---------------------------------------------------------------------------
# Competitor codecs (native/competitors.cpp): the XOR-family and PDE codecs
# the reference times against ALP, one core a stream (table 6).
# ---------------------------------------------------------------------------

_CODEC_IDS = {"gorillas": 0, "chimp": 1, "chimp128": 2, "patas": 3,
              "pde": 4}
_RING_CODECS = {"chimp128", "patas"}       # need a [2^14] int64 scratch
PDE_EXCEPTION = 23                         # PDE's exponent code of a patch


@functools.cache
def competitors_lib() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(build_competitors()[0]))
    for name in ("gorillas", "chimp", "chimp128", "patas"):
        enc = getattr(dll, f"cmp_{name}_encode_f64")
        enc.argtypes = [_P, _L, _P] + ([_P] if name in _RING_CODECS else [])
        enc.restype = _L
        dec = getattr(dll, f"cmp_{name}_decode_f64")
        dec.argtypes = [_P, _L, _P]
        dec.restype = None
    sigs = {
        "cmp_pde_decode_f64": ([_P, _P, _L, _P], None),
        "cmp_pde_encode_f64": ([_P, _L, _P, _P], _L),
        "cmp_chunked_decode_f64": ([_I, _P, _P, _P, _P, _L, _P, _I], None),
        "cmp_chunked_encode_f64": ([_I, _P, _P, _P, _L, _P, _P, _P, _I],
                                   None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return dll


def _codec(name: str) -> str:
    if name not in _CODEC_IDS:
        raise ValueError(f"unknown competitor codec {name!r}; one of "
                         f"{sorted(_CODEC_IDS)}")
    return name


def _f64_bits(data: np.ndarray) -> np.ndarray:
    data = np.ascontiguousarray(data)
    if data.dtype != np.float64:
        raise TypeError(f"the native competitors take float64, got "
                        f"{data.dtype}")
    return data.view(np.uint64)


def _xor_capacity(n):
    """Words that hold any stream of n values (~88 bits a value at worst)."""
    return n + (n * 88) // 64 + 4


def competitor_encode(name: str, data: np.ndarray) -> tuple:
    """Encode float64 ``data`` with a native XOR-family codec (gorillas,
    chimp, chimp128, patas).  Returns (stream words u64, bits)."""
    if _codec(name) == "pde":
        raise ValueError("PDE streams come from competitors.pde_codec")
    bits = _f64_bits(data)
    n = len(bits)
    out = np.zeros(_xor_capacity(n), np.uint64)
    fn = getattr(competitors_lib(), f"cmp_{name}_encode_f64")
    if name in _RING_CODECS:
        scratch = np.zeros(1 << 14, np.int64)
        nbits = fn(_p(bits), n, _p(out), _p(scratch))
    else:
        nbits = fn(_p(bits), n, _p(out))
    return out[:(nbits + 63) // 64], int(nbits)


def competitor_decode(name: str, stream: np.ndarray, n: int,
                      out: np.ndarray | None = None) -> np.ndarray:
    """Decode ``n`` doubles of a native XOR-family stream.  ``out``: a u64
    [n] buffer to decode into (a bench passes one whose pages are touched
    already: a fresh page faults on first write, which would be timed as
    the codec's work)."""
    if _codec(name) == "pde":
        raise ValueError("PDE decodes through pde_decode")
    if out is None:
        out = np.empty(n, np.uint64)
    if out.dtype != np.uint64 or out.shape != (n,):
        raise ValueError(f"out must be u64 [{n}]")
    stream = np.ascontiguousarray(stream, np.uint64)
    getattr(competitors_lib(), f"cmp_{name}_decode_f64")(
        _p(stream), n, _p(out))
    return out.view(np.float64)


def pde_decode(sig: np.ndarray, exp: np.ndarray,
               patches: np.ndarray) -> np.ndarray:
    """Native PDE decode (``sig * 10^-exp``, one core) and the patch
    scatter; equal to ``competitors.pde_codec.pde_decode`` bit for bit."""
    n = len(sig)
    out = np.empty(n, np.float64)
    exp = np.ascontiguousarray(exp, np.uint8)
    sig = np.ascontiguousarray(sig, np.int32)
    competitors_lib().cmp_pde_decode_f64(_p(sig), _p(exp), n, _p(out))
    if len(patches):
        out[exp == PDE_EXCEPTION] = patches
    return out


def pde_chunk_stream(sig: np.ndarray, exp: np.ndarray) -> np.ndarray:
    """One PDE chunk as the chunked decoder reads it: sig (i32 [n]) then
    exp (u8 [n]), each padded to whole u64 words."""
    n = len(sig)
    sig_words = (n + 1) // 2
    buf = np.zeros(sig_words + (n + 7) // 8, np.uint64)
    buf[:sig_words].view(np.int32)[:n] = sig
    buf[sig_words:].view(np.uint8)[:n] = exp
    return buf


def competitor_decode_chunked(name: str, streams: list, ns: np.ndarray,
                              out: np.ndarray, threads: int) -> None:
    """Decode independent chunk streams on ``threads`` OpenMP threads (the
    reference's morsels at 1, 8 and 16 threads): stream c holds ``ns[c]``
    values and decodes into ``out`` (u64 [sum(ns)], the float64 bits) at
    their place.  PDE's patches are the caller's to scatter afterwards."""
    ns = np.ascontiguousarray(ns, np.int64)
    if len(streams) != len(ns):
        raise ValueError("a value count a stream")
    if out.dtype != np.uint64 or out.shape != (int(ns.sum()),):
        raise ValueError(f"out must be u64 [{int(ns.sum())}]")
    word_off = np.zeros(len(streams) + 1, np.int64)
    np.cumsum([len(s) for s in streams], out=word_off[1:])
    flat = (np.concatenate(streams).astype(np.uint64, copy=False)
            if streams else np.zeros(1, np.uint64))
    out_off = np.zeros(len(streams), np.int64)
    np.cumsum(ns[:-1], out=out_off[1:])
    competitors_lib().cmp_chunked_decode_f64(
        _CODEC_IDS[_codec(name)], _p(flat), _p(word_off), _p(ns),
        _p(out_off), len(streams), _p(out), threads)


_SCRATCH: dict = {}


def _scratch(name: str, n: int, dtype) -> np.ndarray:
    """A reused output buffer of at least ``n`` elements, grown
    geometrically: a fresh buffer a call would fault its pages in on
    every call, and a bench would time the faults."""
    buf = _SCRATCH.get(name)
    if buf is None or buf.size < n:
        buf = np.empty(max(n, 2 * (buf.size if buf is not None else 0)),
                       dtype)
        _SCRATCH[name] = buf
    return buf[:n]


def competitor_encode_chunked(name: str, data: np.ndarray, chunk: int,
                              threads: int) -> tuple:
    """Encode float64 ``data`` in independent chunks of ``chunk`` values
    on ``threads`` OpenMP threads (a PDE chunk is its
    :func:`pde_chunk_stream`, patches not taken out).  Returns (flat u64
    words, word_off i64 [chunks], out_words i64 [chunks], ns i64
    [chunks]): chunk c's stream is ``flat[word_off[c]:word_off[c] +
    out_words[c]]``.  ``flat`` is a reused buffer: the next call
    overwrites it."""
    bits = _f64_bits(data)
    n = len(bits)
    n_chunks = -(-n // chunk)
    ns = np.full(n_chunks, chunk, np.int64)
    if n % chunk:
        ns[-1] = n % chunk
    in_off = np.zeros(n_chunks, np.int64)
    np.cumsum(ns[:-1], out=in_off[1:])
    caps = ((ns + 1) // 2 + (ns + 7) // 8 if _codec(name) == "pde"
            else _xor_capacity(ns))
    cap_off = np.zeros(n_chunks, np.int64)
    np.cumsum(caps[:-1], out=cap_off[1:])
    out = _scratch("cmp_enc", int(caps.sum()), np.uint64)
    out_words = np.zeros(n_chunks, np.int64)
    competitors_lib().cmp_chunked_encode_f64(
        _CODEC_IDS[name], _p(bits), _p(in_off), _p(ns), n_chunks, _p(out),
        _p(cap_off), _p(out_words), threads)
    return out, cap_off, out_words, ns
