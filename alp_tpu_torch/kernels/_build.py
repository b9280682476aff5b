"""Build and load the port's CUDA kernels: one ``nvcc`` call, ``ctypes``.

Every ``alp_tpu_torch/csrc/*.cu`` source is compiled for Hopper (sm_90a)
in a single ``nvcc`` invocation into a shared library with a plain C
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
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# (name, argtypes) of every C entry in csrc/
ENTRIES = {
    # packed, bw, base, fact, frac, rows, out, n, stream
    "alp_falp_f64": [_P, _I, _P, _P, _P, _P, _P, _LL, _P],
    "alp_falp_f32": [_P, _I, _P, _P, _P, _P, _P, _LL, _P],
    # right, rbw, left, lbw, dict, dict_size, rows, out, n, stream
    "alp_rd_f64": [_P, _I, _P, _I, _P, _P, _P, _P, _LL, _P],
    "alp_rd_f32": [_P, _I, _P, _I, _P, _P, _P, _P, _LL, _P],
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
    t0 = time.perf_counter()
    try:
        done = subprocess.run(
            [nvcc, *FLAGS, "-o", str(tmp), *map(str, sources)],
            check=True, capture_output=True, text=True, timeout=600)
    except subprocess.CalledProcessError as e:
        raise KernelBuildError(
            f"nvcc failed:\n{e.stdout}\n{e.stderr}") from e
    except (OSError, subprocess.SubprocessError) as e:
        raise KernelBuildError(f"nvcc is not usable: {e}") from e
    os.replace(tmp, lib_file)
    return {"path": lib_file, "seconds": time.perf_counter() - t0,
            "log": done.stdout + done.stderr}


@functools.cache
def lib() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(build()["path"]))
    for name, argtypes in ENTRIES.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll
