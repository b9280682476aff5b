"""Columnar container: the ALPT byte format, host compress, decompress.

Counterpart of ``alp_tpu/container.py``.  A column is cut into vectors of
1024 values and rowgroups of 100 vectors (reference
include/alp/config.hpp:11-15); a trailing partial vector is padded with the
column's last value and ``n_values`` records the true length.  Each
rowgroup takes ALP (per-vector (e, f) pair, FFOR-packed integers,
exceptions) or ALP_RD (dictionary-coded left bits, raw right bits).

* ``compress`` runs on the host: the native engine plans every rowgroup,
  encodes and packs the ALP vectors; ALP_RD rowgroups are split and packed
  with the PyTorch ops on the CPU.  Its blobs equal the JAX package's
  byte for byte.
* ``decompress`` decodes on a device through the plan in
  ``kernels.decode``: the hand-written CUDA kernels on a card, their plain
  PyTorch versions when the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import struct

import numpy as np
import torch

from . import constants as C
from . import native
from .constants import constants_for
from .oracle.rd import rd_encoder_init
from .ops import fastlanes as fl
from .ops.rd import rd_encode_vectors

_MAGIC = b"ALPT"
_VERSION = 2
_FLAG_ENC_MAX = 1
_HEAD = "<4sHBBQII"


@dataclasses.dataclass
class CompressedColumn:
    """Compressed representation of one float64/float32 column (host
    NumPy arrays, the fields of the JAX package's column)."""
    dtype: np.dtype
    n_values: int
    n_vectors: int
    # per rowgroup
    rg_scheme: np.ndarray          # u8[n_rg]: SCHEME_ALP / SCHEME_ALP_RD
    rd_dict: np.ndarray            # u16[n_rg, 8] (zeros for ALP rowgroups)
    rd_dict_size: np.ndarray       # u8[n_rg]
    rd_left_bw: np.ndarray         # u8[n_rg]
    rd_right_bw: np.ndarray        # u8[n_rg]
    # per vector
    fac: np.ndarray                # u8[n_vec]
    exp: np.ndarray                # u8[n_vec]
    bit_width: np.ndarray          # u8[n_vec] (ALP; RD uses the rg widths)
    base: np.ndarray               # st[n_vec] (FOR base; 0 for RD)
    exc_count: np.ndarray          # u16[n_vec]
    # ragged payloads (lists of per-vector arrays)
    packed: list                   # ALP: FFOR words; RD: right-part words
    left_packed: list              # RD: u16 index words ([] for ALP)
    exc_values: list               # ALP: values; RD: u16 raw left parts
    exc_positions: list            # u16 positions
    # format v2: exact per-vector max FFOR delta (0 for RD vectors)
    enc_max: np.ndarray | None = None

    @property
    def n_rowgroups(self) -> int:
        return len(self.rg_scheme)

    def compressed_size_bytes(self) -> int:
        return len(self.to_bytes())

    def bits_per_value(self) -> float:
        """Reference cost model (alp.cpp:14-49; SURVEY.md §2.2), each
        rowgroup priced by its own scheme."""
        tc = constants_for(self.dtype)
        alp_overhead = (8 + 8 + 8 + 64) / C.VECTOR_SIZE
        rd_overhead = (C.MAX_RD_DICTIONARY_SIZE * 16) / C.ROWGROUP_SIZE
        total = 0.0
        for v in range(self.n_vectors):
            rg = v // C.N_VECTORS_PER_ROWGROUP
            if self.rg_scheme[rg] == C.SCHEME_ALP:
                total += (int(self.bit_width[v])
                          + int(self.exc_count[v])
                          * (tc.exception_size + C.EXCEPTION_POSITION_SIZE)
                          / C.VECTOR_SIZE
                          + alp_overhead)
            else:
                total += (int(self.rd_left_bw[rg]) + int(self.rd_right_bw[rg])
                          + int(self.exc_count[v])
                          * (C.RD_EXCEPTION_SIZE
                             + C.RD_EXCEPTION_POSITION_SIZE)
                          / C.VECTOR_SIZE
                          + rd_overhead)
        return total / max(self.n_vectors, 1)

    # -- serialization -----------------------------------------------------

    def to_bytes(self) -> bytes:
        dtype_tag = 0 if self.dtype == np.float64 else 1
        flags = _FLAG_ENC_MAX if self.enc_max is not None else 0
        head = struct.pack(_HEAD, _MAGIC, _VERSION, dtype_tag, flags,
                           self.n_values, self.n_vectors, self.n_rowgroups)
        tc = constants_for(self.dtype)

        def ragged(parts, dt):
            if not parts:
                return b""
            return np.concatenate([np.asarray(p, dt) for p in parts]).tobytes()

        sections = [
            self.rg_scheme.astype(np.uint8).tobytes(),
            self.rd_dict.astype(np.uint16).tobytes(),
            self.rd_dict_size.astype(np.uint8).tobytes(),
            self.rd_left_bw.astype(np.uint8).tobytes(),
            self.rd_right_bw.astype(np.uint8).tobytes(),
            self.fac.astype(np.uint8).tobytes(),
            self.exp.astype(np.uint8).tobytes(),
            self.bit_width.astype(np.uint8).tobytes(),
            self.base.tobytes(),
            self.exc_count.astype(np.uint16).tobytes(),
            (self.enc_max.astype(np.uint64).tobytes()
             if self.enc_max is not None else b""),
            ragged(self.packed, tc.ut),
            ragged(self.left_packed, np.uint16),
            b"".join(np.asarray(p).tobytes() for p in self.exc_values),
            ragged(self.exc_positions, np.uint16),
        ]
        return head + b"".join(sections)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "CompressedColumn":
        if len(buf) < struct.calcsize(_HEAD):
            raise ValueError("truncated ALPT buffer: no header")
        magic, ver, dtype_tag, flags, n_values, n_vec, n_rg = \
            struct.unpack_from(_HEAD, buf, 0)
        if magic != _MAGIC or ver not in (1, 2):
            raise ValueError("not an ALPT v1/v2 buffer")
        if dtype_tag not in (0, 1):
            raise ValueError(f"bad dtype tag {dtype_tag}")
        dtype = np.dtype(np.float64 if dtype_tag == 0 else np.float32)
        tc = constants_for(dtype)
        off = struct.calcsize(_HEAD)

        # geometry must be consistent before any count sizes an allocation
        if n_vec < 1 or n_vec != max(1, -(-n_values // C.VECTOR_SIZE)):
            raise ValueError(
                f"n_vectors {n_vec} inconsistent with n_values {n_values}")
        if n_rg != max(1, -(-n_vec // C.N_VECTORS_PER_ROWGROUP)):
            raise ValueError(
                f"n_rowgroups {n_rg} inconsistent with n_vectors {n_vec}")

        def take(dt, count):
            nonlocal off
            dt = np.dtype(dt)
            end = off + dt.itemsize * count
            if end > len(buf):
                raise ValueError(
                    f"truncated ALPT buffer: need {end} bytes, "
                    f"have {len(buf)}")
            arr = np.frombuffer(buf, dt, count, off)
            off = end
            return arr

        rg_scheme = take(np.uint8, n_rg)
        rd_dict = take(np.uint16, n_rg * 8).reshape(n_rg, 8)
        rd_dict_size = take(np.uint8, n_rg)
        rd_left_bw = take(np.uint8, n_rg)
        rd_right_bw = take(np.uint8, n_rg)
        fac = take(np.uint8, n_vec)
        exp = take(np.uint8, n_vec)
        bit_width = take(np.uint8, n_vec)
        base = take(tc.st, n_vec)
        exc_count = take(np.uint16, n_vec)
        enc_max = None
        if ver >= 2 and (flags & _FLAG_ENC_MAX):
            enc_max = take(np.uint64, n_vec)

        eb = tc.exact_type_bit_size
        if not np.all(np.isin(rg_scheme, (C.SCHEME_ALP, C.SCHEME_ALP_RD))):
            raise ValueError("invalid rowgroup scheme byte")
        if bit_width.max(initial=0) > eb:
            raise ValueError(f"bit_width exceeds {eb}")
        if rd_right_bw.max(initial=0) > eb or rd_left_bw.max(initial=0) > 16:
            raise ValueError("RD bit widths out of range")
        if exc_count.max(initial=0) > C.VECTOR_SIZE:
            raise ValueError("exceptions_count exceeds vector size")

        L = C.VECTOR_SIZE // eb
        L16 = C.VECTOR_SIZE // 16
        vec_rg = np.arange(n_vec) // C.N_VECTORS_PER_ROWGROUP
        is_alp = rg_scheme[vec_rg] == C.SCHEME_ALP
        if enc_max is not None:
            chk = is_alp & (bit_width < eb)
            if np.any(enc_max[chk] >> bit_width[chk].astype(np.uint64)):
                raise ValueError("enc_max exceeds bit_width range")

        def split_section(sizes, dt):
            flat = take(dt, int(sizes.sum()))
            return np.split(flat, np.cumsum(sizes[:-1], dtype=np.int64))

        packed = split_section(np.where(
            is_alp, bit_width.astype(np.int64) * L,
            rd_right_bw[vec_rg].astype(np.int64) * L), tc.ut)
        left_packed = split_section(np.where(
            is_alp, 0, rd_left_bw[vec_rg].astype(np.int64) * L16), np.uint16)
        # exc_values is dtype-ragged (values for ALP, u16 left parts for
        # RD): split the byte stream, then view each piece
        ev_bytes = exc_count.astype(np.int64) * np.where(
            is_alp, tc.pt.itemsize, 2)
        exc_values = [p.view(dtype) if a else p.view(np.uint16)
                      for p, a in zip(split_section(ev_bytes, np.uint8),
                                      is_alp)]
        exc_positions = split_section(exc_count.astype(np.int64), np.uint16)
        return cls(dtype, n_values, n_vec, rg_scheme, rd_dict, rd_dict_size,
                   rd_left_bw, rd_right_bw, fac, exp, bit_width, base,
                   exc_count, packed, left_packed, exc_values, exc_positions,
                   enc_max=enc_max)


# ---------------------------------------------------------------------------
# Compress (host)
# ---------------------------------------------------------------------------

def _pad_to_vectors(data: np.ndarray):
    n = len(data)
    n_vec = max(1, math.ceil(n / C.VECTOR_SIZE))
    if n == n_vec * C.VECTOR_SIZE:
        return data.reshape(n_vec, C.VECTOR_SIZE), n_vec
    padded = np.zeros(n_vec * C.VECTOR_SIZE, dtype=data.dtype)
    padded[:n] = data
    if n:
        padded[n:] = data[n - 1]
    return padded.reshape(n_vec, C.VECTOR_SIZE), n_vec


def compress(data: np.ndarray) -> CompressedColumn:
    """Compress a 1-D float64/float32 array on the host (adaptive
    ALP / ALP_RD per rowgroup)."""
    data = np.ascontiguousarray(data)
    tc = constants_for(data.dtype)
    f64 = data.dtype == np.float64
    vectors, n_vec = _pad_to_vectors(data)
    n_rg = max(1, math.ceil(n_vec / C.N_VECTORS_PER_ROWGROUP))
    flat = vectors.reshape(-1)
    vec_rg = np.arange(n_vec) // C.N_VECTORS_PER_ROWGROUP

    # --- planning: the native sampler, top-k search and scheme choice ----
    schemes, combos_rg, k_rg = (native.init_f64_multi if f64
                                else native.init_f32_multi)(flat, n_rg)
    rg_scheme = np.where(schemes == C.SCHEME_ALP_RD, C.SCHEME_ALP_RD,
                         C.SCHEME_ALP).astype(np.uint8)
    rd_states = {
        rg: rd_encoder_init(
            flat[rg * C.ROWGROUP_SIZE:
                 min(n_vec * C.VECTOR_SIZE, (rg + 1) * C.ROWGROUP_SIZE)],
            0, tc)
        for rg in np.nonzero(rg_scheme == C.SCHEME_ALP_RD)[0].tolist()}

    fac = np.zeros(n_vec, np.uint8)
    exp = np.zeros(n_vec, np.uint8)
    bit_width = np.zeros(n_vec, np.uint8)
    base = np.zeros(n_vec, tc.st)
    enc_max = np.zeros(n_vec, np.uint64)
    exc_count = np.zeros(n_vec, np.uint16)
    packed = [None] * n_vec
    left_packed = [np.empty(0, np.uint16)] * n_vec
    exc_values = [None] * n_vec
    exc_positions = [None] * n_vec
    alp_idx = np.nonzero(rg_scheme[vec_rg] == C.SCHEME_ALP)[0]
    rd_idx = np.nonzero(rg_scheme[vec_rg] == C.SCHEME_ALP_RD)[0]

    # --- ALP vectors: one native encode and one ragged pack per column ----
    if alp_idx.size:
        # an ALP rowgroup offers its first k candidates, an ALP_RD one the
        # single pair (0, 0) (its encode is discarded)
        is_alp_rg = rg_scheme == C.SCHEME_ALP
        k_rg = np.where(is_alp_rg, np.maximum(k_rg, 1), 1).astype(np.int32)
        keep = (np.arange(C.MAX_K_COMBINATIONS)[None, :] < k_rg[:, None]) \
            & is_alp_rg[:, None]
        combos_rg = np.where(keep[:, :, None], combos_rg, 0).astype(np.int32)
        res = (native.encode_f64_multi if f64 else native.encode_f32_multi)(
            vectors, combos_rg, k_rg)
        for key, dst in (("fac", fac), ("exp", exp), ("bit_width", bit_width),
                         ("base", base), ("exc_count", exc_count),
                         ("enc_max", enc_max)):
            dst[alp_idx] = res[key][alp_idx]
        empty_pos = np.empty(0, np.uint16)
        empty_val = np.empty(0, data.dtype)
        for v in alp_idx:
            exc_positions[v] = empty_pos
            exc_values[v] = empty_val
        nz = alp_idx[res["exc_count"][alp_idx] > 0]
        if nz.size:
            cnts = res["exc_count"][nz].astype(np.int64)
            ends = np.cumsum(cnts)
            rows = np.repeat(nz, cnts)
            cols = np.arange(int(ends[-1])) - np.repeat(ends - cnts, cnts)
            splits = ends[:-1]
            for v, p, w in zip(
                    nz, np.split(res["exc_positions"][rows, cols], splits),
                    np.split(res["exc_values"][rows, cols], splits)):
                exc_positions[v] = p
                exc_values[v] = w
        # RD vectors pack at bit width 0 here and are replaced below
        bw_pack = bit_width.copy()
        bw_pack[rd_idx] = 0
        words, off = (native.ffor_ragged if f64 else native.ffor_ragged32)(
            res["encoded"], bw_pack, base)
        for v in alp_idx:
            packed[v] = words[off[v]:off[v + 1]]

    # --- ALP_RD rowgroups: split and pack with the PyTorch ops (CPU) ------
    for rg, stt in rd_states.items():
        sel = np.arange(rg * C.N_VECTORS_PER_ROWGROUP,
                        min(n_vec, (rg + 1) * C.N_VECTORS_PER_ROWGROUP))
        m = len(sel)
        dict_pad = np.full((m, C.MAX_RD_DICTIONARY_SIZE), 0xFFFF, np.int64)
        dict_pad[:, :stt.actual_dictionary_size] = stt.left_parts_dict
        right, left_idx, exc_mask, left_raw = rd_encode_vectors(
            fl.words_from_numpy(vectors[sel].view(tc.ut)),
            torch.full((m,), stt.right_bit_width), torch.from_numpy(dict_pad),
            torch.full((m,), stt.actual_dictionary_size))
        pk_r = fl.ffor_pack(right, torch.zeros(m, dtype=right.dtype),
                            stt.right_bit_width).numpy().view(tc.ut)
        pk_l = fl.ffor_pack(left_idx, torch.zeros(m, dtype=torch.int16),
                            stt.left_bit_width).numpy().view(np.uint16)
        exc_mask = exc_mask.numpy()
        left_raw = left_raw.numpy().astype(np.uint16)
        for r, v in enumerate(sel):
            pos = np.nonzero(exc_mask[r])[0].astype(np.uint16)
            packed[v] = pk_r[r]
            left_packed[v] = pk_l[r]
            exc_positions[v] = pos
            exc_values[v] = left_raw[r][pos]
            exc_count[v] = len(pos)

    rd_dict = np.zeros((n_rg, C.MAX_RD_DICTIONARY_SIZE), np.uint16)
    rd_dict_size = np.zeros(n_rg, np.uint8)
    rd_left_bw = np.zeros(n_rg, np.uint8)
    rd_right_bw = np.zeros(n_rg, np.uint8)
    for rg, stt in rd_states.items():
        rd_dict[rg, :stt.actual_dictionary_size] = stt.left_parts_dict
        rd_dict_size[rg] = stt.actual_dictionary_size
        rd_left_bw[rg] = stt.left_bit_width
        rd_right_bw[rg] = stt.right_bit_width

    return CompressedColumn(
        dtype=np.dtype(data.dtype), n_values=len(data), n_vectors=n_vec,
        rg_scheme=rg_scheme, rd_dict=rd_dict, rd_dict_size=rd_dict_size,
        rd_left_bw=rd_left_bw, rd_right_bw=rd_right_bw,
        fac=fac, exp=exp, bit_width=bit_width, base=base,
        exc_count=exc_count, packed=packed, left_packed=left_packed,
        exc_values=exc_values, exc_positions=exc_positions,
        enc_max=enc_max)


# ---------------------------------------------------------------------------
# Decompress
# ---------------------------------------------------------------------------

def decompress(col: CompressedColumn, device=None) -> torch.Tensor:
    """Bit-exact inverse of :func:`compress`: a 1-D tensor of
    ``col.n_values`` values on ``device``.

    ``device=None`` means ``"cuda"`` and raises when no card is present;
    ``device="cpu"`` runs the kernels' plain PyTorch versions."""
    from .kernels.decode import decompress_device
    return decompress_device(col, device).reshape(-1)[:col.n_values]
