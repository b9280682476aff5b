"""Whole-column compress and decompress over a mesh of ranks.

Counterpart of ``alp_tpu/parallel/container_par.py``.  Planning (the
sampler, the top-k (e, f) candidates of every rowgroup and the ALP_RD
dictionaries) is small and runs on the host of every rank, replicated, as
host ``compress`` runs it (``container.plan_rowgroups``: the native
engine's sampler and search, ``oracle.rd``).  The per-vector work runs on
each rank's run of the vectors, on its device: the second planning level
(K11/K14), the encode (K9/K12), the pack (K10/K13) and the ALP_RD split
(``device_compress.encode_pack``).  Each rank turns its run into the ALPT
sections of those vectors; an ordered gather (the section sizes first,
then the bytes) joins them into the column's sections, so every rank
returns the column whose ``to_bytes()`` equals ``compress(data)``'s.

``decompress_sharded`` decodes each rank's share of a float64 column and
gathers the values on every rank (``sharded.sharded_decode``); a float32
column decodes on the rank's device without the mesh, as the JAX package
does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from .. import device_compress as dc
from ..constants import constants_for
from ..container import (CompressedColumn, _pad_to_vectors, alpt_bytes,
                         decompress, plan_rowgroups, rd_tables,
                         vector_sections)
from .sharded import gather_rows, mesh_device, share, sharded_decode

RG = C.N_VECTORS_PER_ROWGROUP
N_SECTIONS = 10                    # container.vector_sections


def compress_sharded(data: np.ndarray, mesh) -> CompressedColumn:
    """Compress a 1-D float64/float32 array with the per-vector work split
    over ``mesh`` (``sharded.make_mesh``; every rank passes the same data).
    Every rank returns the same column, equal to ``compress(data)``'s byte
    for byte."""
    data = np.ascontiguousarray(data)
    tc = constants_for(data.dtype)
    vectors, n_vec = _pad_to_vectors(data)
    rd, combos_rg, k_rg, rd_states = plan_rowgroups(vectors, tc)
    rd_dict, rd_dict_size, lbw_rg, rbw_rg = rd_tables(rd_states, len(rd))

    lo, hi = share(n_vec, mesh)
    dev = mesh_device(mesh)
    sections = [b""] * N_SECTIONS
    if hi > lo:
        rgs = np.arange(lo, hi) // RG
        local = torch.from_numpy(vectors[lo:hi]).to(dev)
        k_v = torch.from_numpy(k_rg[rgs]).to(dev)
        fac, exp = dc._second_level(
            local[:, ::C.VECTOR_SIZE // C.SAMPLES_PER_VECTOR].contiguous(),
            torch.from_numpy(combos_rg[rgs]).to(dev), k_v,
            bool((k_rg[rgs] > 1).any()))
        enc = dc.encode_pack(local, fac, exp, rgs, rd[rgs], rbw_rg, lbw_rg,
                             rd_states)
        m = enc.meta
        sections = vector_sections(
            data.dtype, m[0], m[1], m[2], m[3], enc.exc_count,
            m[4].view(np.uint64), [dc._host(enc.flat, "words").view(tc.ut)],
            enc.left_packed, enc.exc_values, enc.exc_positions)

    # ordered gather: every rank's section sizes, then its bytes
    sizes = torch.tensor([[len(s) for s in sections]], dtype=torch.int64)
    payload = torch.from_numpy(np.frombuffer(b"".join(sections),
                                             np.uint8).copy())
    all_sizes = [p.cpu()[0].tolist() for p in gather_rows(mesh, sizes)]
    parts = [p.cpu().numpy().tobytes() for p in gather_rows(mesh, payload)]
    joined = [[] for _ in range(N_SECTIONS)]
    for sz, part in zip(all_sizes, parts):
        at = np.concatenate([[0], np.cumsum(sz)])
        for i in range(N_SECTIONS):
            joined[i].append(part[at[i]:at[i + 1]])
    blob = alpt_bytes(
        data.dtype, len(data), n_vec,
        (np.where(rd, C.SCHEME_ALP_RD, C.SCHEME_ALP).astype(np.uint8),
         rd_dict, rd_dict_size, lbw_rg.astype(np.uint8),
         rbw_rg.astype(np.uint8)),
        [b"".join(s) for s in joined], True)
    return CompressedColumn.from_bytes(blob)


def decompress_sharded(col: CompressedColumn, mesh) -> torch.Tensor:
    """The column's values on this rank's device, bit-exact: float64
    decoded a share a rank and gathered (``sharded.sharded_decode``),
    float32 decoded on the rank's device alone."""
    if col.dtype != np.float64:
        return decompress(col, mesh_device(mesh))
    return sharded_decode(mesh, col)
