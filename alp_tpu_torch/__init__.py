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
The JAX package ``alp_tpu`` beside it is the reference: the port's blobs
equal its blobs byte for byte, its decoded values equal its values bit for
bit, and its query answers equal its answers bit for bit.  This package
imports neither JAX nor ``alp_tpu``.
"""

from .container import CompressedColumn, compress, decompress
from .device_compress import compress_device
from .engine import (groupby_keys, query_compression,
                     query_count_exceptions, query_distinct,
                     query_filter_count, query_filter_sum, query_groupby,
                     query_histogram, query_max, query_mean, query_median,
                     query_min, query_quantile, query_scan, query_sum,
                     query_topk, query_window)

__all__ = ["CompressedColumn", "compress", "compress_device", "decompress",
           "groupby_keys", "query_compression", "query_count_exceptions",
           "query_distinct", "query_filter_count", "query_filter_sum",
           "query_groupby", "query_histogram", "query_max", "query_mean",
           "query_median", "query_min", "query_quantile", "query_scan",
           "query_sum", "query_topk", "query_window"]
