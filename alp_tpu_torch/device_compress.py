"""Device compression of float64 and float32 columns: planning, encode and
pack on a card.

Counterpart of ``alp_tpu/device_compress.py:compress_device`` (and of
``alp_tpu.container.compress(..., device=True)``).  The column is staged
to the device once (or is already there: ``values=``, e.g. the output of
``decompress``); only the planner's small tables, the samples of ALP_RD
rowgroups, the per-vector metadata, the packed words and the exceptions
cross to the host.  The blob equals host compress's byte for byte
(``container.compress``, itself equal to the JAX package's).

The two precisions share every step; the kernels named are f64's, with
f32's in brackets.

1. Planning, every rowgroup on the device (the tail rowgroup too: its
   vectors are whole once the last one is padded, so the sampler takes
   the same 32-value strides from it).  K11 (K14) scores the 190 (66)
   (e, f) pairs on each sampled vector; ``ops.alp.first_level_vote`` picks
   each rowgroup's scheme and top-k pairs; for ALP rowgroups with k > 1,
   K11 (K14) scores the k pairs on every vector's stride and
   ``ops.alp.accept_scan`` picks its pair.  ALP_RD rowgroups build their
   dictionary on the host from their samples (``oracle.rd``).
2. Encode: K9 (K12) encodes every vector with its pair and reduces the
   stats that ``finalize_encode_stats`` turns into bit width, base,
   enc_max, exception count and fill.
3. Pack: K10 (K13) packs each bit width's vectors into one flat buffer in
   the blob's vector order, exception slots patched with the fill; ALP_RD
   vectors are split and looked up with ``ops.rd.rd_encode_vectors``, their
   right parts packed by K10 (K13) at base 0 and their left indexes by
   ``ops.fastlanes.ffor_pack``.
4. The host assembles the ``CompressedColumn``.

Unlike the JAX package there is no host re-plan or re-encode of "rare"
vectors or rowgroups, and no host planning of the tail: Hopper's FP64 and
FP32 compute subnormals, and FP64 |x| in [2^52, 2^104), exactly
(``csrc/encode.cuh``).  The f32 search follows the host engine, not the
JAX package's TPU scorer, on -0.0 samples (``kernels.score``).
``device="cpu"`` runs every kernel's plain version.

``make_device_compress_step`` (steps 1 and 2 of the ALP rowgroups) and
``make_pack_step`` (step 3) are the same device work as loop steps for
``benchlib.loop_bench``, with no host fetch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import constants as C
from . import tracing
from .benchlib import carry_into_rows
from .container import CompressedColumn, _pad_to_vectors, rd_tables
from .engine import LoopStep, _checksum
from .kernels.decode import resolve_device
from .kernels.encode import alp_encode_f32, alp_encode_f64
from .kernels.ffor import ffor_pack_f32, ffor_pack_f64
from .kernels.score import (first_level_scores_f32, first_level_scores_f64,
                            second_level_scores_f32, second_level_scores_f64)
from .ops import fastlanes as fl
from .ops.alp import accept_scan, bit_width_of, first_level_vote
from .ops.rd import rd_encode_vectors
from .oracle.rd import first_level_sample, rd_state_from_sample

VECTOR = C.VECTOR_SIZE
RG = C.N_VECTORS_PER_ROWGROUP
SAMPLES = C.SAMPLES_PER_VECTOR
STRIDE = VECTOR // SAMPLES
# bytes compress_device copied from a card to the host (reset_to_host)
TO_HOST = tracing.Counters("alp.compress.to_host.", ("bytes",))
reset_to_host = TO_HOST.reset


def _host(t: torch.Tensor, site: str) -> np.ndarray:
    """``t`` copied to the host, the fetch ``alp.fetch.compress.<site>``."""
    if t.is_cuda:
        TO_HOST["bytes"] += t.numel() * t.element_size()
    with tracing.span("alp.fetch.compress." + site):
        return t.cpu().numpy()


def _up(a: np.ndarray, device, site: str) -> torch.Tensor:
    """``a`` uploaded to ``device``, the fetch ``alp.fetch.compress.<site>``
    (an upload from pageable memory waits for the stream)."""
    with tracing.span("alp.fetch.compress." + site):
        return torch.from_numpy(a).to(device)


def _float_only(dtype) -> None:
    if dtype not in (np.float64, np.float32, torch.float64, torch.float32):
        raise TypeError(f"device compress takes float64 or float32, got "
                        f"{dtype}")


def _stage(data, values, n_values, device) -> tuple:
    """([n_vec, 1024] float64 or float32 on the device, n_values)."""
    if (data is None) == (values is None):
        raise ValueError("pass data or values")
    if data is not None:
        data = np.ascontiguousarray(data)
        _float_only(data.dtype)
        if data.ndim != 1:
            raise ValueError("data must be 1-D")
        vectors, _ = _pad_to_vectors(data)
        return _up(vectors, resolve_device(device), "stage"), len(data)
    _float_only(values.dtype)
    if device is not None:
        want = resolve_device(device)
        if want.type != values.device.type or want.index not in (
                None, values.device.index):
            raise ValueError(f"values lie on {values.device}, not {want}")
    flat = values.reshape(-1)
    n_values = flat.numel() if n_values is None else n_values
    n_vec = max(1, math.ceil(n_values / VECTOR))
    if flat.numel() not in (n_values, n_vec * VECTOR):
        raise ValueError(f"{flat.numel()} values for n_values {n_values}")
    pad = n_vec * VECTOR - flat.numel()
    if pad:    # container._pad_to_vectors: repeat the last value
        last = (flat[-1:] if flat.numel() else
                torch.zeros(1, dtype=flat.dtype, device=flat.device))
        flat = torch.cat([flat, last.expand(pad)])
    return flat.reshape(n_vec, VECTOR).contiguous(), n_values


def _sampled_vectors(n_vectors: int) -> np.ndarray:
    """The vectors whose 32-value stride the first-level sampler takes
    from a rowgroup of ``n_vectors`` whole vectors (every 12th)."""
    pos = first_level_sample(np.arange(n_vectors * VECTOR), 0)
    ids = pos[::SAMPLES] // VECTOR
    if not np.array_equal(pos.reshape(-1, SAMPLES),
                          ids[:, None] * VECTOR + np.arange(0, VECTOR,
                                                            STRIDE)):
        raise RuntimeError("the sampler does not take whole strides")
    return ids


def _sample_groups(n_vec: int) -> list:
    """The vectors the first-level sampler takes a stride of, as int64
    arrays [rowgroups, sampled vectors]: one for the whole rowgroups, one
    for a partial last rowgroup."""
    n_full = n_vec // RG
    groups = []
    if n_full:
        groups.append(np.arange(n_full)[:, None] * RG
                      + _sampled_vectors(RG)[None, :])
    if n_vec % RG:
        groups.append(n_full * RG + _sampled_vectors(n_vec % RG)[None, :])
    return groups


def _first_level(strides, groups: list, tc, checked: bool = True) -> tuple:
    """Each rowgroup's (combos [n_rg, 5, 2], k [n_rg], is_rd [n_rg]) on the
    device from the strides of its sampled vectors (``groups``: the
    tensors of :func:`_sample_groups` on the device); an ALP_RD rowgroup's
    combos and k are zeroed."""
    score = (first_level_scores_f64 if tc is C.DOUBLE
             else first_level_scores_f32)
    parts = []
    for ids in groups:
        est, ne = score(strides[ids], checked=checked)
        parts.append(first_level_vote(est, ne, SAMPLES, tc))
    combos, k, is_rd = (torch.cat(x) for x in zip(*parts))
    return (torch.where(is_rd[:, None, None], 0, combos),
            torch.where(is_rd, 0, k), is_rd)


def finalize_encode_stats(n, exc_count, first, vmin, vmax) -> tuple:
    """Per-vector analyze and patch quantities from K9's (K12's) stats
    (encoder.hpp:109-120, 382-399): (bit_width int32, base, enc_max int64
    (the unsigned max - base of n's width), exception count int32, fill;
    base and fill of n's dtype).  The fill is the vector's first
    non-exception n in value order; a vector of exceptions only gets bit
    width 0, base 0 and fill 0."""
    any_ok = first < VECTOR
    mx = torch.where(any_ok, vmax, 0)
    mn = torch.where(any_ok, vmin, 0)
    enc_max = mx.to(torch.int64) - mn.to(torch.int64)   # modulo 2^64
    if n.dtype == torch.int32:
        enc_max = enc_max & 0xFFFFFFFF                    # uint32(max - min)
    k = first.clamp(max=VECTOR - 1).to(torch.int64)[:, None]
    fill = torch.where(any_ok, torch.gather(n, 1, k)[:, 0], 0)
    return bit_width_of(enc_max), mn, enc_max, exc_count, fill


def _split(flat: np.ndarray, counts: np.ndarray) -> list:
    return np.split(flat, np.cumsum(counts)[:-1])


def _rd_states(strides, sample_ids: list, rd_np: np.ndarray, tc) -> dict:
    """The ALP_RD rowgroups' states (cut and dictionary), built on the host
    from their first-level samples: rowgroup -> ``oracle.rd.RdState``."""
    rgs = np.nonzero(rd_np)[0]
    if not rgs.size:
        return {}
    ids = np.concatenate([sample_ids[rg] for rg in rgs])
    samples = _host(strides[_up(ids, strides.device, "rd_sample_ids")],
                    "rd_samples")
    lens = [len(sample_ids[rg]) * SAMPLES for rg in rgs]
    return {rg: rd_state_from_sample(sample, tc) for rg, sample in
            zip(rgs.tolist(), _split(samples.reshape(-1), lens))}


def _second_level(strides, combos, k, multi_any: bool,
                  checked: bool = True) -> tuple:
    """Each vector's (fac, exp), int32 [n_vec]: its rowgroup's first pair,
    or, where the rowgroup kept k > 1 pairs and ``multi_any`` says that
    some did, the accept scan's choice over their scores on the vector's
    stride."""
    fac = combos[:, 0, 1].contiguous()
    exp = combos[:, 0, 0].contiguous()
    if not multi_any:
        return fac, exp
    multi = k > 1
    score = (second_level_scores_f64 if strides.dtype == torch.float64
             else second_level_scores_f32)
    est = score(strides, combos.contiguous(), torch.where(multi, k, 0),
                checked=checked)
    fac2, exp2 = accept_scan(est, combos, k)
    return torch.where(multi, fac2, fac), torch.where(multi, exp2, exp)


def _encode_stats(vectors, fac, exp, is_rd_v, checked: bool = True) -> tuple:
    """Step 2: K9 (K12) and its stats.  Returns (n, exc, base, fill, [bit
    width, base, enc_max, exception count] int64 [m], zero on the ALP_RD
    vectors ``is_rd_v``, which carry no ALP metadata, as host compress)."""
    encode = alp_encode_f64 if vectors.dtype == torch.float64 else \
        alp_encode_f32
    n, exc, *stats = encode(vectors, exp, fac, stats=True, checked=checked)
    bw, base, enc_max, n_exc, fill = finalize_encode_stats(n, *stats)
    return n, exc, base, fill, [torch.where(is_rd_v, 0, x.to(torch.int64))
                                for x in (bw, base, enc_max, n_exc)]


def _exceptions(mask, raw) -> tuple:
    """The exceptions of ``mask`` [n, 1024] in row-major order: their
    positions in the row (u16) and their entries of ``raw`` [n, 1024], as
    host arrays."""
    with tracing.span("alp.fetch.compress.exception_mask"):
        at = mask.nonzero()
    pos = _host(at[:, 1].to(torch.int16), "exception_positions")
    return pos.view(np.uint16), _host(raw[at[:, 0], at[:, 1]],
                                      "exception_values")


def _pack_rd(vectors, sel: np.ndarray, rgs: np.ndarray, rbw: int, lbw: int,
             rd_states: dict, flat, offsets_t) -> tuple:
    """ALP_RD rows ``sel`` of ``vectors`` (of rowgroups ``rgs``) of one
    (right, left) bit width: split and look up (``ops.rd``), right parts
    packed by K10 (K13) at base 0 into ``flat`` (of the patterns' dtype),
    left indexes by ``ops.fastlanes.ffor_pack``.  Returns (left words [m,
    lbw * 64] u16, exception positions, raw left parts (u16), counts), on
    the host."""
    dev = vectors.device
    m = len(sel)
    dict_pad = np.full((m, C.MAX_RD_DICTIONARY_SIZE), 0xFFFF, np.int64)
    dict_size = np.zeros(m, np.int64)
    for j, rg in enumerate(rgs.tolist()):
        stt = rd_states[rg]
        dict_pad[j, :stt.actual_dictionary_size] = stt.left_parts_dict
        dict_size[j] = stt.actual_dictionary_size
    sel_t = _up(sel, dev, "rd_rows")
    right, left_idx, exc_mask, left_raw = rd_encode_vectors(
        vectors[sel_t].view(flat.dtype), torch.full((m,), rbw, device=dev),
        _up(dict_pad, dev, "rd_dict"), _up(dict_size, dev, "rd_dict_size"))
    pack = ffor_pack_f64 if flat.dtype == torch.int64 else ffor_pack_f32
    pack(right, torch.zeros(m, dtype=flat.dtype, device=dev), rbw, out=flat,
         offsets=offsets_t[sel_t])
    lefts = _host(fl.ffor_pack(left_idx,
                               torch.zeros(m, dtype=torch.int16, device=dev),
                               lbw), "rd_lefts").view(np.uint16)
    pos, raw = _exceptions(exc_mask, left_raw)
    return lefts, pos, raw.astype(np.uint16), _host(exc_mask.sum(dim=1),
                                                    "rd_exception_counts")


@dataclasses.dataclass
class Encoded:
    """Steps 2 and 3 over some vectors of a column, in their order: ``meta``
    int64 [6, m] (fac, exp, bit width, base, enc_max, ALP exception count;
    0 past fac and exp for ALP_RD vectors), ``exc_count`` u16 [m] (both
    schemes), ``words`` int64 [m] (packed words of each vector), ``flat``
    (every vector's packed words in order, on the device) and the
    per-vector lists of the container."""
    meta: np.ndarray
    exc_count: np.ndarray
    words: np.ndarray
    flat: torch.Tensor
    left_packed: list
    exc_positions: list
    exc_values: list


def encode_pack(vectors, fac, exp, rgs: np.ndarray, is_rd: np.ndarray,
                rbw_rg: np.ndarray, lbw_rg: np.ndarray,
                rd_states: dict) -> Encoded:
    """Encode and pack ``vectors`` [m, 1024] on their device: vector i of
    rowgroup ``rgs[i]``, ALP_RD where ``is_rd[i]``, ALP with the pair
    (``exp[i]``, ``fac[i]``) (int32 tensors) elsewhere."""
    f64 = vectors.dtype == torch.float64
    tc = C.DOUBLE if f64 else C.FLOAT
    word = torch.int64 if f64 else torch.int32       # n and packed words
    lanes = VECTOR // tc.exact_type_bit_size
    pack = ffor_pack_f64 if f64 else ffor_pack_f32
    dev = vectors.device
    m = vectors.shape[0]

    # --- 2. encode -------------------------------------------------------
    with tracing.span("alp.compress.encode"):
        is_rd_v = _up(is_rd, dev, "is_rd")
        zeros = torch.zeros(m, dtype=torch.int64, device=dev)
        alp_meta = [zeros] * 4                 # bw, base, enc_max, n_exc
        if not is_rd.all():
            n, exc, base, fill, alp_meta = _encode_stats(vectors, fac, exp,
                                                         is_rd_v)
        meta = _host(torch.stack([fac.to(torch.int64), exp.to(torch.int64),
                                  *alp_meta]), "meta")
        bw_np, exc_count = meta[2], meta[5].astype(np.uint16)

    # --- 3. pack every vector's words into one flat buffer ----------------
    with tracing.span("alp.compress.pack"):
        words = np.where(is_rd, rbw_rg[rgs], bw_np) * lanes
        offsets = np.zeros(m + 1, np.int64)
        np.cumsum(words, out=offsets[1:])
        flat = torch.empty(int(offsets[-1]), dtype=word, device=dev)
        offsets_t = _up(offsets[:-1], dev, "offsets")
        alp_vec = np.nonzero(~is_rd)[0]
        for b in np.unique(bw_np[alp_vec]).tolist():
            if b:
                sel = _up(alp_vec[bw_np[alp_vec] == b], dev, "pack_rows")
                pack(n, base, b, exc=exc, fill=fill, rows=sel, out=flat,
                     offsets=offsets_t[sel])
    exc_positions = [np.empty(0, np.uint16)] * m
    exc_values = [np.empty(0, tc.pt)] * m
    with tracing.span("alp.compress.exceptions"):
        if exc_count.any():
            pos, val = _exceptions(exc & ~is_rd_v[:, None], vectors)
            has = np.nonzero(exc_count)[0]
            for v, p, x in zip(has.tolist(), _split(pos, exc_count[has]),
                               _split(val, exc_count[has])):
                exc_positions[v], exc_values[v] = p, x
    left_packed = [np.empty(0, np.uint16)] * m
    rd_vec = np.nonzero(is_rd)[0]
    widths = np.stack([rbw_rg[rgs[rd_vec]], lbw_rg[rgs[rd_vec]]], 1)
    with tracing.span("alp.compress.rd"):
        for rbw, lbw in sorted({tuple(w) for w in widths.tolist()}):
            sel = rd_vec[(widths[:, 0] == rbw) & (widths[:, 1] == lbw)]
            lefts, pos, raw, counts = _pack_rd(vectors, sel, rgs[sel], rbw,
                                               lbw, rd_states, flat,
                                               offsets_t)
            for v, lw, p, x, c in zip(sel.tolist(), lefts,
                                      _split(pos, counts),
                                      _split(raw, counts), counts.tolist()):
                left_packed[v], exc_positions[v], exc_values[v] = lw, p, x
                exc_count[v] = c
    return Encoded(meta, exc_count, words, flat, left_packed, exc_positions,
                   exc_values)


@tracing.spanned("alp.compress")
def compress_device(data=None, *, values=None, n_values=None,
                    device=None) -> CompressedColumn:
    """Compress a float64 or float32 column with its hot path on a device.

    ``data``: a 1-D numpy float64 or float32 array, staged to ``device``
    once (``None`` means ``"cuda"`` and raises when no card is present;
    ``"cpu"`` runs the plain versions).  Or ``values``: a float64 or
    float32 tensor already on the device, ``[n_vec, 1024]`` or flat, with
    ``n_values`` real values; a missing partial last vector is padded with
    the last value (``container._pad_to_vectors``).  Other dtypes raise
    ``TypeError``.  The blob equals ``container.compress``'s."""
    with tracing.span("alp.compress.stage"):
        vectors, n_values = _stage(data, values, n_values, device)
    tc = C.DOUBLE if vectors.dtype == torch.float64 else C.FLOAT
    dev = vectors.device
    n_vec = vectors.shape[0]
    n_rg = math.ceil(n_vec / RG)
    vec_rg = np.arange(n_vec) // RG

    # --- 1. planning -----------------------------------------------------
    with tracing.span("alp.compress.first_level"):
        strides = vectors[:, ::STRIDE].contiguous()
        groups = _sample_groups(n_vec)
        sample_ids = [row for ids in groups for row in ids]
        combos_rg, k_rg, rd_rg = _first_level(
            strides, [_up(ids, dev, "sample_ids") for ids in groups], tc)
        k_np, rd_np = _host(torch.stack([k_rg, rd_rg.to(torch.int32)]),
                            "first_level")
        rd_np = rd_np.astype(bool)
    with tracing.span("alp.compress.rd_states"):
        rd_states = _rd_states(strides, sample_ids, rd_np, tc)
        rd_dict, rd_dict_size, lbw_rg, rbw_rg = rd_tables(rd_states, n_rg)
    with tracing.span("alp.compress.second_level"):
        vec_rg_t = _up(vec_rg, dev, "vector_rowgroups")
        fac, exp = _second_level(strides, combos_rg[vec_rg_t],
                                 k_rg[vec_rg_t], bool((k_np > 1).any()))

    # --- 2, 3. encode and pack ------------------------------------------
    enc = encode_pack(vectors, fac, exp, vec_rg, rd_np[vec_rg], rbw_rg,
                      lbw_rg, rd_states)

    # --- 4. assemble -----------------------------------------------------
    meta = enc.meta
    with tracing.span("alp.compress.assemble"):
        packed = _split(_host(enc.flat, "words").view(tc.ut), enc.words)
    return CompressedColumn(
        dtype=np.dtype(tc.pt), n_values=n_values, n_vectors=n_vec,
        rg_scheme=np.where(rd_np, C.SCHEME_ALP_RD,
                           C.SCHEME_ALP).astype(np.uint8),
        rd_dict=rd_dict, rd_dict_size=rd_dict_size,
        rd_left_bw=lbw_rg.astype(np.uint8),
        rd_right_bw=rbw_rg.astype(np.uint8),
        fac=meta[0].astype(np.uint8), exp=meta[1].astype(np.uint8),
        bit_width=meta[2].astype(np.uint8), base=meta[3].astype(tc.st),
        exc_count=enc.exc_count,
        packed=packed,
        left_packed=enc.left_packed, exc_values=enc.exc_values,
        exc_positions=enc.exc_positions,
        enc_max=meta[4].view(np.uint64).copy())


# ---------------------------------------------------------------------------
# Loop steps of the device compress (alp_tpu/device_compress.py
# make_device_compress_step, make_pack_step)
# ---------------------------------------------------------------------------

def _f64_vectors(values) -> None:
    if values.dtype != torch.float64:
        raise TypeError(f"the device compress steps take float64 values, "
                        f"got {values.dtype}")
    if values.dim() != 2 or values.shape[1] != VECTOR or \
            not values.is_contiguous():
        raise ValueError(f"values must be contiguous [n_vec, {VECTOR}], got "
                         f"{tuple(values.shape)}")


class StepMeta(NamedTuple):
    """The per-vector outcome of :func:`make_device_compress_step`'s
    result, each a tensor [n_vec] on the values' device (0 on ALP_RD
    vectors but ``fill``)."""
    fac: torch.Tensor              # int32
    exp: torch.Tensor              # int32
    bit_width: torch.Tensor        # int64, as the rest
    base: torch.Tensor
    enc_max: torch.Tensor
    exc_count: torch.Tensor
    fill: torch.Tensor


def make_device_compress_step(values, k_max: int = 5) -> tuple:
    """Loop step of ``compress_device``'s device work on float64 vectors
    ``values`` [n_vec, 1024] already on the device.  Returns ``(step,
    (values,))`` for ``benchlib.loop_bench``.

    ``step.result(carry, values)`` runs, as ``compress_device`` does: the
    32-value strides, the first planning level (K11 over every sampled
    stride and pair, ``first_level_vote``), the second (K11 over each
    vector's pairs, ``accept_scan``) and K9's encode with its stats and
    ``finalize_encode_stats``; it returns a :class:`StepMeta`.  Nothing
    is fetched to the host and nothing synchronises: the kernels are
    called with ``checked=False`` (the planner's pairs lie in the tables by
    construction), and the host value that ``compress_device`` fetches to
    choose its second level is the static ``k_max`` here: ``k_max == 1``
    leaves the second level out (the reference skips it at k == 1,
    encoder.hpp:404), which equals ``compress_device`` only where every
    rowgroup keeps one pair; ``k_max > 1`` runs it.  ALP_RD rowgroups get
    zero metadata and no exception count: their dictionaries, which
    ``compress_device`` builds on the host, are left out.

    The carry is XORed into the first value of every vector before the
    work and out again after it, so ``values`` is left as it was and, at
    carry 0, the result equals ``compress_device``'s per-vector metadata
    (and host ``compress``'s)."""
    _f64_vectors(values)
    if not 1 <= k_max <= C.MAX_K_COMBINATIONS:
        raise ValueError(f"k_max must be in 1..{C.MAX_K_COMBINATIONS}")
    dev = values.device
    n_vec = values.shape[0]
    groups = [torch.from_numpy(ids).to(dev) for ids in _sample_groups(n_vec)]
    vec_rg = torch.arange(n_vec, device=dev) // RG

    def result(carry, values):
        carry_into_rows(values, carry)
        strides = values[:, ::STRIDE].contiguous()
        combos, k, is_rd = _first_level(strides, groups, C.DOUBLE,
                                        checked=False)
        fac, exp = _second_level(strides, combos[vec_rg], k[vec_rg],
                                 k_max > 1, checked=False)
        _, _, _, fill, meta = _encode_stats(values, fac, exp, is_rd[vec_rg],
                                            checked=False)
        carry_into_rows(values, carry)
        return StepMeta(fac, exp, *meta, fill)

    return LoopStep(result, lambda m, carry: carry ^ _checksum(*m)), (values,)


def make_pack_step(col: CompressedColumn, values) -> tuple:
    """Loop step of ``compress_device``'s pack (step 3 of ``encode_pack``)
    over ``col``, a float64 column of ALP rowgroups, and ``values``, its
    vectors [n_vec, 1024] on the device.  Returns ``(step, args)``.

    Set-up, once: K9 encodes ``values`` with ``col``'s pairs and
    ``finalize_encode_stats`` gives the bases and fills, which must give
    ``col``'s bit widths and bases; the flat word buffer takes ``col``'s
    offsets.  ``step.result(carry, *args)`` is K10 over each bit width's
    vectors, with the exception fill fused into the pack, into that buffer,
    which it returns; at carry 0 it equals ``col.packed`` flattened.  The
    carry is XORed into the first encoded word of every vector and out
    again after the pack.

    Each bucket's vectors are K10's ``rows``: the kernel reads them where
    they lie, so there is no gather and no pass over the other vectors
    (the JAX step packs every row once a bit width when there are at most
    four, a workaround for the TPU's gather)."""
    _f64_vectors(values)
    if col.dtype != np.float64:
        raise TypeError("make_pack_step takes a float64 column")
    if (col.rg_scheme != C.SCHEME_ALP).any():
        raise ValueError("make_pack_step takes a column of ALP rowgroups")
    if values.shape[0] != col.n_vectors:
        raise ValueError(f"{values.shape[0]} vectors for a column of "
                         f"{col.n_vectors}")
    dev = values.device
    bw_np = col.bit_width.astype(np.int64)
    fac = torch.from_numpy(col.fac.astype(np.int32)).to(dev)
    exp = torch.from_numpy(col.exp.astype(np.int32)).to(dev)
    n, exc, base, fill, meta = _encode_stats(
        values, fac, exp, torch.zeros(col.n_vectors, dtype=torch.bool,
                                      device=dev))
    got_bw, got_base = _host(torch.stack(meta[:2]), "step_meta")
    if not (np.array_equal(got_bw, bw_np)
            and np.array_equal(got_base, col.base.astype(np.int64))):
        raise ValueError("values do not encode to the column's bit widths "
                         "and bases")
    words = bw_np * (VECTOR // 64)
    offsets = np.zeros(col.n_vectors + 1, np.int64)
    np.cumsum(words, out=offsets[1:])
    flat = torch.zeros(int(offsets[-1]), dtype=torch.int64, device=dev)
    buckets = []
    for b in np.unique(bw_np[bw_np > 0]).tolist():
        sel = np.nonzero(bw_np == b)[0]
        buckets.append((b, torch.from_numpy(sel).to(dev),
                        torch.from_numpy(offsets[sel]).to(dev)))
    firsts = torch.from_numpy(offsets[:-1][words > 0]).to(dev)

    def result(carry, n, exc, fill, base, flat):
        carry_into_rows(n, carry)
        for b, rows, at in buckets:
            ffor_pack_f64(n, base, b, exc=exc, fill=fill, rows=rows,
                          out=flat, offsets=at, checked=False)
        carry_into_rows(n, carry)
        return flat

    def fold(flat, carry):
        return carry ^ flat[firsts].sum()

    return LoopStep(result, fold), (n, exc, fill, base, flat)
