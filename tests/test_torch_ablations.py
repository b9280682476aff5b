"""``kernel_ablations.py`` must refuse to run without a card (it exits at
run time, too, when one of its text edits no longer applies to
``alp_tpu_torch/csrc``)."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_the_script_needs_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, str(ROOT / "kernel_ablations.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert run.returncode != 0
    assert "no CUDA card" in run.stderr
