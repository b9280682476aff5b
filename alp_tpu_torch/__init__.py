"""alp_tpu_torch: the PyTorch / CUDA port of alp_tpu.

Adaptive lossless compression of float64/float32 columns (ALP classic and
ALP_RD, per rowgroup), the ``ALPT`` byte format, host compress and decode
on an NVIDIA Hopper card through hand-written CUDA kernels.  The JAX
package ``alp_tpu`` beside it is the reference: the port's blobs equal its
blobs byte for byte, and its decoded values equal its values bit for bit.
This package imports neither JAX nor ``alp_tpu``.
"""

from .container import CompressedColumn, compress, decompress

__all__ = ["CompressedColumn", "compress", "decompress"]
