"""Decode plans: whole-column decode through the port's kernels.

Counterpart of ``alp_tpu/kernels/decode.py`` (``build_plan``,
``DecodePlan.run(patch=True)``, ``decompress_device``).  ``build_plan``
buckets a column's vectors by scheme and bit width on the host (ALP by
bit width, ALP_RD by right and left bit width, so mixed ALP / ALP_RD
columns split into both kinds) and moves each bucket's packed words and
per-vector metadata to the device once.  ``DecodePlan.run`` launches one
kernel per bucket, each writing its vectors' values straight into their
rows of the column's output, then scatters the exceptions.  For the
exact SUM (``engine``) the plan also carries ``n_values`` and, built on
the device at first use, the per-vector CSR of its ALP exceptions
(``exc_ptr``) and the compact scratch layout of its ALP_RD vectors
(``decode_rd``); the key kernels of the predicate and order queries also
read the CSR of its ALP_RD exceptions (``rd_exc_ptr``), and TOP-K decodes
a few vectors exactly (``decode_vectors``).  ``decompress`` builds none of
these.

The JAX package's plan also picks one of six f64 kernel variants per
bucket and stages plan-time softfloat constants (``decode.py:219-401``);
those exist because the TPU has no IEEE FP64 and fills 128 lanes.  Hopper
has FP64 and the port keeps the reference word layout, so neither is
ported: one kernel decodes every f64 bucket.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import constants as C
from ..constants import constants_for
from ..ops.fastlanes import low_mask, narrow, words_from_numpy
from . import exact_sum as kes
from . import falp as kfalp

VECTOR_SIZE = C.VECTOR_SIZE


def resolve_device(device) -> torch.device:
    """``None`` -> ``"cuda"``.  A CUDA device must be present: there is no
    silent move to the CPU; ``"cpu"`` runs the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to decode "
                "with the plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class Bucket:
    """Vectors decoded by one kernel launch."""
    scheme: int                    # SCHEME_ALP (K1/K2) or SCHEME_ALP_RD
    bw: int                        # ALP bit width, or RD right bit width
    lbw: int                       # RD left bit width (0 for ALP)
    rows: torch.Tensor             # int64 [n]: output row of each vector
    args: tuple                    # the wrapper's tensor arguments

    @property
    def n_vectors(self) -> int:
        return self.rows.shape[0]


@dataclasses.dataclass
class DecodePlan:
    dtype: np.dtype
    n_values: int
    n_vectors: int
    device: torch.device
    buckets: list
    exc_index: torch.Tensor        # int64 flat positions, ALP exceptions
    exc_bits: torch.Tensor         # their value bits
    rd_exc_index: torch.Tensor     # int64 flat positions, RD exceptions
    rd_exc_left: torch.Tensor      # int64 raw left parts
    rd_exc_rbw: torch.Tensor       # int64 right bit width of each
    # (least key, largest key) of the column's values, unsigned ints: set at
    # the first MIN, MAX or QUANTILE (engine._plan_key_extent) and kept
    key_extent: tuple | None = None
    # (int64 [n_vectors, W + 3] exact-SUM totals, [n_vectors, 2] least and
    # largest keys) of every vector: set at the first ordered GROUP-BY or
    # window query (engine._plan_vector_sums, K18) and kept
    vector_sums: tuple | None = None

    @property
    def f64(self) -> bool:
        return self.dtype == np.float64

    @property
    def bits_dtype(self) -> torch.dtype:
        return _bits_dtype(self.dtype)

    def launch(self, bucket: Bucket, out: torch.Tensor, rows=None) -> None:
        """Decode one bucket into its rows of ``out`` [N, 1024] (values, or
        bit patterns for ALP_RD): the vectors' own rows, or ``rows``."""
        rows = bucket.rows if rows is None else rows
        if bucket.scheme == C.SCHEME_ALP:
            fn = (kfalp.falp_decode_f64 if self.f64
                  else kfalp.falp_decode_f32)
            fn(bucket.args[0], bucket.bw, *bucket.args[1:], out=out,
               rows=rows)
        else:
            fn = (kfalp.rd_decode_dict_f64 if self.f64
                  else kfalp.rd_decode_dict_f32)
            right, left, dictionary, dict_size = bucket.args
            fn(right, bucket.bw, left, bucket.lbw, dictionary, dict_size,
               out=out.view(self.bits_dtype), rows=rows)

    def patch_rd(self, flat: torch.Tensor, index: torch.Tensor) -> None:
        """Scatter the ALP_RD exceptions' full bits into ``flat`` at
        ``index`` (``rd_exc_index``, or its compact counterpart): the raw
        left part above the right bits already decoded."""
        if index.numel():
            flat[index] = rd_exception_bits(flat[index], self.rd_exc_left,
                                            self.rd_exc_rbw,
                                            64 if self.f64 else 32)

    @functools.cached_property
    def exc_ptr(self) -> torch.Tensor:
        """int64 [n_vectors + 1]: vector v's ALP exceptions are entries
        exc_ptr[v] .. exc_ptr[v + 1] of ``exc_index`` and ``exc_bits``
        (which are in vector order).  Built at the first SUM, on the
        device; ``decompress`` never needs it."""
        return _csr(self.exc_index, self.n_vectors, self.device)

    @functools.cached_property
    def rd_exc_ptr(self) -> torch.Tensor:
        """The same CSR over ``rd_exc_index`` / ``rd_exc_left`` /
        ``rd_exc_rbw``, the ALP_RD exceptions; built at the first query
        that reads it."""
        return _csr(self.rd_exc_index, self.n_vectors, self.device)

    def decode_vectors(self, vec_ids: torch.Tensor) -> torch.Tensor:
        """The exact values of vectors ``vec_ids`` (int64 [m], distinct),
        [m, 1024] on the plan's device, their exceptions in (the pad of a
        partial last vector is left as decoded).  Each bucket's selected
        rows go through its kernel (K1-K4) into their rows of the output,
        then both exception kinds are written in from their CSRs."""
        m = vec_ids.shape[0]
        out = torch.empty((m, VECTOR_SIZE), dtype=_value_dtype(self.dtype),
                          device=self.device)
        slot = torch.full((self.n_vectors,), -1, dtype=torch.int64,
                          device=self.device)
        slot[vec_ids] = torch.arange(m, device=self.device)
        for bucket in self.buckets:
            picked = slot[bucket.rows]
            sel = torch.nonzero(picked >= 0).flatten()
            if not sel.numel():
                continue
            part = dataclasses.replace(
                bucket, rows=bucket.rows[sel],
                args=tuple(a[sel] for a in bucket.args))
            self.launch(part, out, rows=picked[sel])
        bits = out.view(self.bits_dtype)
        kes.patch_exceptions(bits, vec_ids, self.exc_ptr, self.exc_index,
                             self.exc_bits)
        patch_rd_exceptions(bits, vec_ids, self.rd_exc_ptr,
                            self.rd_exc_index, self.rd_exc_left,
                            self.rd_exc_rbw)
        return out

    @functools.cached_property
    def _rd_layout(self):
        """(the scratch rows of each ALP_RD bucket, the vector id of every
        scratch row, the RD exceptions' flat positions in the scratch)."""
        rd = [b for b in self.buckets if b.scheme == C.SCHEME_ALP_RD]
        vec = (torch.cat([b.rows for b in rd]) if rd else
               torch.zeros(0, dtype=torch.int64, device=self.device))
        order = torch.arange(vec.shape[0], device=self.device)
        rows = list(torch.split(order, [b.n_vectors for b in rd]))
        scratch_row = torch.zeros(self.n_vectors, dtype=torch.int64,
                                  device=self.device)
        scratch_row[vec] = order
        index = (scratch_row[self.rd_exc_index // VECTOR_SIZE] * VECTOR_SIZE
                 + self.rd_exc_index % VECTOR_SIZE)
        return rows, vec, index

    def decode_rd(self) -> tuple:
        """The ALP_RD vectors alone, decoded (K3/K4) into a compact scratch
        with their exceptions in: (bit patterns [n_rd, 1024], the vector
        id of each row).  The SUM reads them so; the layout is built at
        the first call and kept."""
        rows, vec, index = self._rd_layout
        scratch = torch.empty((vec.shape[0], VECTOR_SIZE),
                              dtype=self.bits_dtype, device=self.device)
        rd = [b for b in self.buckets if b.scheme == C.SCHEME_ALP_RD]
        for bucket, r in zip(rd, rows):
            self.launch(bucket, scratch, rows=r)
        self.patch_rd(scratch.view(-1), index)
        return scratch, vec

    def run(self) -> torch.Tensor:
        """The full bit-exact decode: [n_vectors, 1024] values on the
        plan's device (one launch per bucket, then the exception scatter of
        decoder::patch_exceptions, decoder.hpp:141-149)."""
        out = torch.empty((self.n_vectors, VECTOR_SIZE),
                          dtype=_value_dtype(self.dtype), device=self.device)
        for bucket in self.buckets:
            self.launch(bucket, out)
        flat = out.view(self.bits_dtype).view(-1)
        if self.exc_index.numel():
            flat[self.exc_index] = self.exc_bits
        self.patch_rd(flat, self.rd_exc_index)
        return out


def rd_exception_bits(cur: torch.Tensor, left: torch.Tensor,
                      rbw: torch.Tensor, S: int) -> torch.Tensor:
    """The full S-bit patterns of ALP_RD exceptions: each raw left part
    (int64) above the low ``rbw`` bits of the decoded pattern ``cur``."""
    cur = cur.to(torch.int64)
    one = torch.ones_like(rbw)
    rmask = torch.where(rbw >= 64, low_mask(64),
                        (one << rbw.clamp(max=63)) - 1)
    return narrow((left << rbw) | (cur & rmask), S)


def patch_rd_exceptions(bits, rows, exc_ptr, exc_index, exc_left,
                        rbw) -> None:
    """Write the full bits of every ALP_RD exception of vectors ``rows``
    into ``bits`` [n, 1024] (row i = vector rows[i]), from a per-vector
    CSR over ``exc_index`` (flat positions) and ``exc_left`` (raw left
    parts); ``rbw`` is the right bit width of every exception (a tensor
    of them, or one int)."""
    row, entry = kes.csr_entries(exc_ptr, rows)
    if not entry.numel():
        return
    col = exc_index[entry] & (VECTOR_SIZE - 1)
    left = exc_left[entry]
    rbw = (rbw[entry] if isinstance(rbw, torch.Tensor)
           else torch.full_like(left, rbw))
    bits[row, col] = rd_exception_bits(bits[row, col], left, rbw,
                                       8 * bits.element_size())


def _csr(index: torch.Tensor, n_vectors: int, device) -> torch.Tensor:
    """int64 [n_vectors + 1] row pointers of flat positions ``index``
    (in vector order)."""
    return torch.searchsorted(index // VECTOR_SIZE,
                              torch.arange(n_vectors + 1, device=device))


def _value_dtype(dtype) -> torch.dtype:
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


def _bits_dtype(dtype) -> torch.dtype:
    return torch.int64 if np.dtype(dtype) == np.float64 else torch.int32


def _stack(parts: list, width: int, dt) -> np.ndarray:
    if not parts or width == 0:
        return np.zeros((len(parts), width), dt)
    return np.concatenate(parts).astype(dt, copy=False).reshape(-1, width)


def build_plan(col, device=None) -> DecodePlan:
    """Bucket a compressed column (``container.CompressedColumn``) and move
    each bucket's words and metadata to ``device``."""
    dev = resolve_device(device)
    tc = constants_for(col.dtype)
    S = tc.exact_type_bit_size
    L = VECTOR_SIZE // S
    n_vec = col.n_vectors
    vec_rg = np.arange(n_vec) // C.N_VECTORS_PER_ROWGROUP
    scheme = col.rg_scheme[vec_rg]
    alp_idx = np.nonzero(scheme == C.SCHEME_ALP)[0]
    rd_idx = np.nonzero(scheme == C.SCHEME_ALP_RD)[0]

    def put(a: np.ndarray) -> torch.Tensor:
        return words_from_numpy(a).to(dev) if a.dtype.kind in "ui" else \
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    buckets = []
    bws = col.bit_width[alp_idx].astype(np.int64)
    for bw in np.unique(bws).tolist():
        sel = alp_idx[bws == bw]
        # the float FACT table has 10 entries (reference OOB quirk): clamp
        # the index as the host decode does (container.py:586-590)
        fac = np.minimum(col.fac[sel], len(tc.fact_arr) - 1)
        buckets.append(Bucket(C.SCHEME_ALP, bw, 0, put(sel.astype(np.int64)), (
            put(_stack([col.packed[v] for v in sel], bw * L, tc.ut)),
            put(col.base[sel].astype(tc.st)),
            put(tc.fact_arr[fac].astype(tc.st)),
            put(tc.frac_arr[col.exp[sel]].astype(tc.pt)))))

    rbws = col.rd_right_bw[vec_rg[rd_idx]].astype(np.int64)
    lbws = col.rd_left_bw[vec_rg[rd_idx]].astype(np.int64)
    for rbw, lbw in sorted(set(zip(rbws.tolist(), lbws.tolist()))):
        sel = rd_idx[(rbws == rbw) & (lbws == lbw)]
        rgs = vec_rg[sel]
        buckets.append(Bucket(C.SCHEME_ALP_RD, rbw, lbw,
                              put(sel.astype(np.int64)), (
            put(_stack([col.packed[v] for v in sel], rbw * L, tc.ut)),
            put(_stack([col.left_packed[v] for v in sel],
                       lbw * (VECTOR_SIZE // 16), np.uint16)),
            put(col.rd_dict[rgs].astype(np.uint16)),
            put(col.rd_dict_size[rgs].astype(np.int32)))))

    def exceptions(idx):
        idx = idx[col.exc_count[idx] > 0]
        counts = col.exc_count[idx].astype(np.int64)
        pos = (np.concatenate([col.exc_positions[v] for v in idx])
               .astype(np.int64) if idx.size else np.zeros(0, np.int64))
        flat = np.repeat(idx.astype(np.int64), counts) * VECTOR_SIZE + pos
        vals = [col.exc_values[v] for v in idx]
        return idx, counts, flat, vals

    _, _, alp_flat, alp_vals = exceptions(alp_idx)
    alp_bits = (np.concatenate(alp_vals).view(tc.ut) if alp_vals
                else np.zeros(0, tc.ut))
    rd_vecs, rd_counts, rd_flat, rd_vals = exceptions(rd_idx)
    rd_left = (np.concatenate(rd_vals).astype(np.int64) if rd_vals
               else np.zeros(0, np.int64))
    rd_rbw = np.repeat(col.rd_right_bw[vec_rg[rd_vecs]].astype(np.int64),
                       rd_counts)

    return DecodePlan(np.dtype(col.dtype), col.n_values, n_vec, dev, buckets,
                      put(alp_flat), put(alp_bits), put(rd_flat),
                      put(rd_left), put(rd_rbw))


def decompress_device(col, device=None) -> torch.Tensor:
    """Decode every vector of a column: [n_vectors, 1024] values on
    ``device`` (``None`` means ``"cuda"``)."""
    return build_plan(col, device).run()
