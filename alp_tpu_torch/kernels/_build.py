"""Build and load the port's CUDA kernels: ``nvcc``, ``ctypes``.

Every ``alp_tpu_torch/csrc/*.cu`` source (they share the headers
``csrc/fastlanes.cuh``, ``csrc/vector.cuh``, ``csrc/digits.cuh`` and
``csrc/encode.cuh``) is
compiled for Hopper
(sm_90a) by its own ``nvcc -c``, all started together, and the objects
are linked by one more ``nvcc`` call into a shared library with a plain C
interface, under ``alp_tpu_torch/_build/`` and named by a hash of the
sources, the flags and the compiler's version.  No PyTorch header is
included, so the build takes seconds.  The library is built at first use,
never at import, and loaded with ``ctypes`` with the ``argtypes`` of every
entry set (pointers and the stream as ``c_void_p``).  Each entry returns
``cudaGetLastError()`` after its launch; the wrappers raise on a nonzero
status.  A missing ``nvcc`` or a failed build raises ``KernelBuildError``.

No fast-math or flush-to-zero flag is passed: decoded subnormals must
survive, and the kernels use the ``_rn`` intrinsics so nothing is
contracted into an FMA.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_D = ctypes.c_double
_F = ctypes.c_float
_ULL = ctypes.c_ulonglong
# (name, argtypes) of every C entry in csrc/
ENTRIES = {
    # packed, bw, base, fact, frac, rows, out, n, stream
    "alp_falp_f64": [_P, _I, _P, _P, _P, _P, _P, _LL, _P],
    "alp_falp_f32": [_P, _I, _P, _P, _P, _P, _P, _LL, _P],
    # right, rbw, left, lbw, dict, dict_size, rows, out, n, stream
    "alp_rd_f64": [_P, _I, _P, _I, _P, _P, _P, _P, _LL, _P],
    "alp_rd_f32": [_P, _I, _P, _I, _P, _P, _P, _P, _LL, _P],
    # bits, vec, n, n_values, out, device, stream
    "alp_exact_sum_f64": [_P, _P, _LL, _LL, _P, _I, _P],
    "alp_exact_sum_f32": [_P, _P, _LL, _LL, _P, _I, _P],
    # packed, bw, base, fact, frac, rows, exc_ptr, exc_index, exc_bits,
    # n, n_values, out, device, stream
    "alp_falp_exact_sum_f64": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                               _P, _I, _P],
    "alp_falp_exact_sum_f32": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                               _P, _I, _P],
    # the same with the key range klo, khi just before out
    "alp_exact_sum_where_f64": [_P, _P, _LL, _LL, _ULL, _ULL, _P, _I, _P],
    "alp_exact_sum_where_f32": [_P, _P, _LL, _LL, _ULL, _ULL, _P, _I, _P],
    "alp_falp_exact_sum_where_f64": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL,
                                     _LL, _ULL, _ULL, _P, _I, _P],
    "alp_falp_exact_sum_where_f32": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL,
                                     _LL, _ULL, _ULL, _P, _I, _P],
    # packed, bw, base, fact, frac, rows, exc_ptr, exc_index, exc_bits, n,
    # n_values, thr, E, bins, device, stream
    "alp_key_counts_alp_f64": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                               _P, _I, _P, _I, _P],
    "alp_key_counts_alp_f32": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                               _P, _I, _P, _I, _P],
    # right, rbw, left, lbw, dict, dict_size, rows, exc_ptr, exc_index,
    # exc_left, n, n_values, thr, E, bins, device, stream
    "alp_key_counts_rd_f64": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _LL,
                              _LL, _P, _I, _P, _I, _P],
    "alp_key_counts_rd_f32": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _LL,
                              _LL, _P, _I, _P, _I, _P],
    # the K15 arguments up to n_values, then out, device, stream
    "alp_key_extremes_alp_f64": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL,
                                 _LL, _P, _I, _P],
    "alp_key_extremes_alp_f32": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL,
                                 _LL, _P, _I, _P],
    "alp_key_extremes_rd_f64": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _LL,
                                _LL, _P, _I, _P],
    "alp_key_extremes_rd_f32": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _LL,
                                _LL, _P, _I, _P],
    # the K15 arguments up to E, then br, R, bins, mm, device, stream
    "alp_rank_pass_alp_f64": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                              _P, _I, _P, _I, _P, _P, _I, _P],
    "alp_rank_pass_alp_f32": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                              _P, _I, _P, _I, _P, _P, _I, _P],
    "alp_rank_pass_rd_f64": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _LL,
                             _LL, _P, _I, _P, _I, _P, _P, _I, _P],
    "alp_rank_pass_rd_f32": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _LL,
                             _LL, _P, _I, _P, _I, _P, _P, _I, _P],
    # K18: the K15 arguments up to n_values, then sums, keys, device,
    # stream
    "alp_vector_sums_alp_f64": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL,
                                _LL, _P, _P, _I, _P],
    "alp_vector_sums_alp_f32": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL,
                                _LL, _P, _P, _I, _P],
    "alp_vector_sums_rd_f64": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _LL,
                               _LL, _P, _P, _I, _P],
    "alp_vector_sums_rd_f32": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _LL,
                               _LL, _P, _P, _I, _P],
    # K19: the K15 arguments up to n_values, then group keys, G, out, ext,
    # device, stream
    "alp_group_reduce_alp_f64": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL,
                                 _LL, _P, _I, _P, _P, _I, _P],
    "alp_group_reduce_alp_f32": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _LL,
                                 _LL, _P, _I, _P, _P, _I, _P],
    "alp_group_reduce_rd_f64": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _LL,
                                _LL, _P, _I, _P, _P, _I, _P],
    "alp_group_reduce_rd_f32": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _LL,
                                _LL, _P, _I, _P, _P, _I, _P],
    # K20: packed, bw, base, fact, frac, n, out, stream
    "alp_variant_sum_f64": [_P, _I, _P, _P, _P, _LL, _P, _P],
    # K21: right, rbw, left, n, out, stream
    "alp_rd_glue_f64": [_P, _I, _P, _LL, _P, _P],
    "alp_rd_glue_f32": [_P, _I, _P, _LL, _P, _P],
    # K22: packed, bw, base, n, out, stream
    "alp_unffor_f64": [_P, _I, _P, _LL, _P, _P],
    "alp_unffor_f32": [_P, _I, _P, _LL, _P, _P],
    # K23: bits, n, keys, device, stream
    "alp_key_extremes_bits_f64": [_P, _LL, _P, _I, _P],
    # values, e, f, exp_tab, frac_tab, fact_tab, magic, upper, n, out_n,
    # out_exc, exc_count, first, vmin, vmax, stream
    "alp_encode_f64": [_P, _P, _P, _P, _P, _P, _D, _D, _LL, _P, _P, _P, _P,
                       _P, _P, _P],
    # values, e, f, exp_tab, frac_tab, fact_tab, fact_len, magic, upper,
    # limit, n, out_n, out_exc, exc_count, first, vmin, vmax, stream
    "alp_encode_f32": [_P, _P, _P, _P, _P, _P, _I, _F, _F, _D, _LL, _P, _P,
                       _P, _P, _P, _P, _P],
    # in, rows, exc, fill, base, bw, offsets, m, out, stream
    "alp_ffor_pack_f64": [_P, _P, _P, _P, _P, _I, _P, _LL, _P, _P],
    "alp_ffor_pack_f32": [_P, _P, _P, _P, _P, _I, _P, _LL, _P, _P],
    # samples, ef, ef_per_segment, n_cand, k_count, n, exp_tab, frac_tab,
    # fact_tab, magic, upper, exc_bits, est, non_exc, stream
    "alp_score_pairs_f64": [_P, _P, _I, _I, _P, _LL, _P, _P, _P, _D, _D, _I,
                            _P, _P, _P],
    # samples, ef, ef_per_segment, n_cand, k_count, n, exp_tab, frac_tab,
    # fact_tab, fact_len, magic, upper, limit, exc_bits, est, non_exc, stream
    "alp_score_pairs_f32": [_P, _P, _I, _I, _P, _LL, _P, _P, _P, _I, _F, _F,
                            _D, _I, _P, _P, _P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the kernel sources."""


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise KernelBuildError("nvcc not found (set CUDA_HOME)")


@functools.cache
def build() -> dict:
    """Build the kernel library if its hashed file is absent.  Returns
    {"path", "seconds" (0.0 when the cached build was current), "log"}."""
    nvcc = nvcc_path()
    sources = sorted(_CSRC.glob("*.cu"))
    try:
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise KernelBuildError(f"nvcc is not usable: {e}") from e
    h = hashlib.sha256(" ".join(FLAGS).encode() + version.encode())
    for src in sorted(_CSRC.iterdir()):
        h.update(src.name.encode() + src.read_bytes())
    lib_file = BUILD_DIR / f"libalp_tpu_torch-{h.hexdigest()[:16]}.so"
    if lib_file.exists():
        return {"path": lib_file, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_file.with_name(f"{lib_file.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    t0 = time.perf_counter()
    try:
        log = _compile_all(nvcc, sources, objs)
        subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                        *map(str, objs)], check=True, capture_output=True,
                       text=True, timeout=600)
    except subprocess.CalledProcessError as e:
        raise KernelBuildError(
            f"nvcc failed:\n{e.stdout}\n{e.stderr}") from e
    except (OSError, subprocess.SubprocessError) as e:
        raise KernelBuildError(f"nvcc is not usable: {e}") from e
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib_file)
    return {"path": lib_file, "seconds": time.perf_counter() - t0,
            "log": log}


def _compile_all(nvcc: str, sources: list, objs: list) -> str:
    """Compile every source to its object, one ``nvcc -c`` each, all at
    once; returns their logs (ptxas's register counts).  Raises
    ``CalledProcessError`` for the first that fails, after every one has
    ended."""
    procs = [subprocess.Popen([nvcc, *FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(sources, objs)]
    try:
        done = [(p, *p.communicate(timeout=600)) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out, err in done:
        if p.returncode:
            raise subprocess.CalledProcessError(p.returncode, p.args, out,
                                                err)
    return "".join(out + err for _, out, err in done)


@functools.cache
def lib() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(build()["path"]))
    for name, argtypes in ENTRIES.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll
