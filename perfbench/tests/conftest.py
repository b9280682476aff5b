"""The benchmark's tests import its harness as ``perfbench/run.py`` does:
``perfbench/`` and the root of the checkout on ``sys.path``."""

import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for path in (str(ROOT), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)
