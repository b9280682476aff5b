"""Dataset registry, readers and published numbers (counterpart of
``alp_tpu/utils``)."""

from . import datasets, io
