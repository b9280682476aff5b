"""The port stands alone: no JAX, no ``alp_tpu``, no silent CPU decode.

* Importing ``alp_tpu_torch`` and every module of it (and ``chip_smoke``)
  in a fresh interpreter leaves ``jax`` and ``alp_tpu`` out of
  ``sys.modules``; the modules include the periphery (the competitor
  codecs, ``utils``, ``reports``, the CLI and ``bench_e2e``), which keeps
  its own copies of the JAX package's numpy-only modules.
* A source scan of the package and ``chip_smoke.py`` finds no import of
  either.
* Decoding with ``device=None`` where no CUDA device exists raises instead
  of falling back to the CPU; ``chip_smoke.py`` exits nonzero without a
  card, and alone in a directory.
* Importing ``alp_tpu_torch.parallel`` starts no process group and no
  process; ``make_mesh`` needs the caller's group and its backend, and
  never picks gloo or the CPU itself.
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


PERIPHERY = ("alp_tpu_torch.__main__", "alp_tpu_torch.bench_e2e",
             "alp_tpu_torch.reports", "alp_tpu_torch.native",
             "alp_tpu_torch.competitors.xor_codecs",
             "alp_tpu_torch.competitors.pde_codec",
             "alp_tpu_torch.competitors.elf_codec",
             "alp_tpu_torch.competitors.zstd_codec",
             "alp_tpu_torch.utils.datasets", "alp_tpu_torch.utils.io",
             "alp_tpu_torch.utils.published")


@pytest.mark.parametrize("module", PERIPHERY)
def test_periphery_modules_are_imported_and_scanned(module):
    assert module in MODULES
    path = ROOT.joinpath(*module.split(".")).with_suffix(".py")
    assert path in SOURCES


def test_periphery_packages_import_nothing_of_alp_tpu():
    code = ("import sys\n"
            "import alp_tpu_torch.competitors, alp_tpu_torch.utils\n"
            "from alp_tpu_torch.competitors import ALL_CODECS\n"
            "assert set(ALL_CODECS) >= {'gorillas', 'chimp', 'chimp128',\n"
            "                           'patas', 'elf'}\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'alp_tpu.'))\n"
            "             or m == 'alp_tpu')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


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


def test_parallel_import_starts_no_process_group():
    code = ("import multiprocessing, sys\n"
            "import torch.distributed as dist\n"
            "import alp_tpu_torch.parallel\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'alp_tpu.'))\n"
            "             or m == 'alp_tpu')\n"
            "started = (dist.is_initialized()\n"
            "           or bool(multiprocessing.active_children()))\n"
            "print(bad, started)\n"
            "sys.exit(1 if bad or started else 0)\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr


def test_make_mesh_needs_the_callers_group_and_backend(tmp_path):
    import torch.distributed as dist
    from alp_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="nccl"):
            make_mesh()                          # a card mesh needs NCCL
        with pytest.raises(ValueError):
            make_mesh(2, "cpu")
        with pytest.raises(ValueError):
            make_mesh(device_type="tpu")
        mesh = make_mesh(1, "cpu")
        assert mesh.device_type == "cpu" and mesh.mesh_dim_names == ("rg",)
    finally:
        dist.destroy_process_group()
