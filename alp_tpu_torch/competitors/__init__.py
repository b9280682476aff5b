"""Competitor codecs for compression-ratio comparisons.

Counterpart of ``alp_tpu/competitors``: size-faithful reimplementations of
the XOR-family codecs the reference benchmarks against (Gorillas, Chimp,
Chimp128, Patas), the Elf erase-based codec, BtrBlocks' Pseudodecimal
(``pde_codec``), and Zstd through a ctypes binding of the system libzstd
(level 3 over rowgroup chunks; plan snapshots use the same binding).
They run on the host in numpy, as in the JAX package: they are the CPU
competitors the reference times.  ``ALL_CODECS`` maps each codec's name
to its bit count of a column (Elf's is None for float32: the reference
build is double-only); zlib stands in for Zstd only when libzstd is
absent.  The native C++ codecs that the end-to-end bench times are in
``alp_tpu_torch.native``.
"""

import numpy as np

from .xor_codecs import (
    gorillas_bits,
    chimp_bits,
    chimp128_bits,
    patas_bits,
    zlib_bits,
    gorillas_roundtrip,
    chimp_roundtrip,
    patas_roundtrip,
    chimp128_roundtrip,
)
from .elf_codec import elf_bits, elf_roundtrip, elf_encode, elf_decode
from .zstd_codec import HAVE_ZSTD, zstd_bits, zstd_roundtrip, zstd_version

ALL_CODECS = {
    "gorillas": gorillas_bits,
    "chimp": chimp_bits,
    "chimp128": chimp128_bits,
    "patas": patas_bits,
}


def _elf_bits_f64_only(data):
    if data.dtype != np.float64:
        return None          # the Elf reference build is double-only
    return elf_bits(data)


ALL_CODECS["elf"] = _elf_bits_f64_only
if HAVE_ZSTD:
    ALL_CODECS["zstd"] = zstd_bits
else:  # pragma: no cover - libzstd is present where the port runs
    ALL_CODECS["zlib"] = zlib_bits
