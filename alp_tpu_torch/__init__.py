"""alp_tpu_torch: the PyTorch / CUDA port of alp_tpu.

Adaptive lossless compression of float64/float32 columns (ALP classic and
ALP_RD, per rowgroup), the ``ALPT`` byte format, host compress, and
compress, decode and queries on an NVIDIA Hopper card through
hand-written CUDA kernels: exact SUM / MEAN (K5-K8) and the predicate and
order queries COUNT WHERE, MIN / MAX, TOP-K, histogram (K15
``key_counts`` and K16 ``key_extremes``), the exact filtered SUM (K5-K8
with a key range), exact QUANTILE / MEDIAN (a bisection over K17
``rank_pass`` passes), and exact GROUP-BY and windowed aggregates (K18
``vector_sum_extremes`` and K19 ``group_reduce``) and COUNT DISTINCT.
A built decode plan can be kept as a file and restored on a card
(``save_plan`` / ``load_plan``, ``plan_store``), and compress, decompress,
SUM, COUNT and GROUP-BY can run over the ranks of a ``torch.distributed``
group, a card each (``compress(x, mesh=...)``, ``parallel``).
Its bench times the card: ``benchlib.loop_bench`` over the loop steps
``make_*_step``, the headline ``python -m alp_tpu_torch.bench`` and the
per-kernel rows ``python -m alp_tpu_torch.bench_speed`` (with K20-K23, the
kernels of the TPU sites only the bench reaches), and the end-to-end rows
``python -m alp_tpu_torch.bench_e2e`` (ALP on the card against the
competitor codecs of ``competitors`` and ``native`` on the host).  The host
decoder ``decompress_host`` decodes a column into numpy through the native
engine (``native/alpcore.cpp``) without a card.  The CLI
``python -m alp_tpu_torch file.bin`` compresses a column of your own;
``utils`` and ``reports`` read datasets and write the reference's CSVs.
The JAX package ``alp_tpu`` beside it is the reference: the port's blobs
equal its blobs byte for byte, its decoded values equal its values bit for
bit, and its query answers equal its answers bit for bit.  This package
imports neither JAX nor ``alp_tpu``.
"""

from .container import (CompressedColumn, compress, decompress,
                        decompress_host)
from .device_compress import compress_device
from .plan_store import load_plan, save_plan
from .engine import (groupby_keys, make_exact_sum_step, make_filter_step,
                     make_groupby_step, make_histogram_step, make_sum_step,
                     make_topk_step, query_compression,
                     query_count_exceptions, query_distinct,
                     query_filter_count, query_filter_sum, query_groupby,
                     query_histogram, query_max, query_mean, query_median,
                     query_min, query_quantile, query_scan, query_sum,
                     query_topk, query_window)
from . import benchlib

__all__ = ["CompressedColumn", "bench", "benchlib", "compress",
           "compress_device", "decompress", "decompress_host",
           "groupby_keys", "load_plan",
           "make_exact_sum_step", "make_filter_step", "make_groupby_step",
           "make_histogram_step", "make_sum_step", "make_topk_step",
           "query_compression", "query_count_exceptions", "query_distinct",
           "query_filter_count", "query_filter_sum", "query_groupby",
           "query_histogram", "query_max", "query_mean", "query_median",
           "query_min", "query_quantile", "query_scan", "query_sum",
           "query_topk", "query_window", "save_plan"]


def __getattr__(name):
    # ``bench`` is imported at first use, so that ``python -m
    # alp_tpu_torch.bench`` does not find it imported already
    if name == "bench":
        import importlib
        return importlib.import_module(".bench", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
