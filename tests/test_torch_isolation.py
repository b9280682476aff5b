"""The port stands alone: no JAX, no ``alp_tpu``, no silent CPU decode.

* Importing ``alp_tpu_torch`` and every module of it (and ``chip_smoke``)
  in a fresh interpreter leaves ``jax`` and ``alp_tpu`` out of
  ``sys.modules``.
* A source scan of the package and ``chip_smoke.py`` finds no import of
  either.
* Decoding with ``device=None`` where no CUDA device exists raises instead
  of falling back to the CPU; ``chip_smoke.py`` exits nonzero without a
  card, and alone in a directory.
"""

import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import alp_tpu_torch
from alp_tpu_torch.kernels import decode

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "alp_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "kernel_ablations.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if p.name != "__init__.py") + ["alp_tpu_torch", "chip_smoke",
                                   "kernel_ablations"]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|alp_tpu)(\.|\s|$)",
                       re.MULTILINE)


def test_import_leaves_jax_and_alp_tpu_unloaded():
    code = ("import sys\n"
            f"for m in {MODULES!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'alp_tpu.'))\n"
            "             or m == 'alp_tpu')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_neither_jax_nor_alp_tpu(path):
    assert not FORBIDDEN.findall(path.read_text())


def test_scan_pattern_catches_the_forbidden_imports():
    for line in ("import jax", "from jax import numpy", "import alp_tpu",
                 "from alp_tpu.container import compress",
                 "    import jax.numpy as jnp"):
        assert FORBIDDEN.search(line), line
    for line in ("import alp_tpu_torch", "from alp_tpu_torch import x",
                 "from .kernels import decode"):
        assert not FORBIDDEN.search(line), line


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    col = alp_tpu_torch.compress(np.linspace(0, 1, 3000))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        alp_tpu_torch.decompress(col)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.decompress_device(col, "cuda")
    with pytest.raises(ValueError):
        decode.build_plan(col, "meta")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_card():
    done = _run_smoke(ROOT)
    assert done.returncode != 0
    assert '"ok": true' not in done.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    done = _run_smoke(tmp_path)
    assert done.returncode != 0
    assert '"ok": true' not in done.stdout
