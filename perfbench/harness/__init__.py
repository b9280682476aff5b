"""The general code of alp_tpu_torch's benchmark (``perfbench/run.py``)."""
