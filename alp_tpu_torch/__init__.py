"""alp_tpu_torch: the PyTorch / CUDA port of alp_tpu.

Adaptive lossless compression of float64/float32 columns (ALP classic and
ALP_RD, per rowgroup), the ``ALPT`` byte format, host compress, and
compress, decode and exact SUM / MEAN on an NVIDIA Hopper card through
hand-written CUDA kernels.  The JAX package ``alp_tpu`` beside it is the
reference: the port's blobs equal its blobs byte for byte, its decoded values equal its
values bit for bit, and its SUM and MEAN equal its answers bit for bit.
This package imports neither JAX nor ``alp_tpu``.
"""

from .container import CompressedColumn, compress, decompress
from .device_compress import compress_device
from .engine import query_mean, query_sum

__all__ = ["CompressedColumn", "compress", "compress_device", "decompress",
           "query_mean", "query_sum"]
