"""The port's (e, f) scoring kernels: wrappers, plain PyTorch versions,
counts.

    K11 score_pairs_f64  <- alp_tpu/kernels/score.py score_pairs_f64 (both
                            planning levels) and first_level_scores_f64
                            (its rows layout)
    K14 score_pairs_f32  <- score_pairs_f32 (both planning levels)

``score_pairs_f64(samples, ef, k_count)`` scores candidate pairs (e, f)
on segments of 32 samples as the reference's (e, f) search does
(encoder.hpp:139-305: encode_value<SAFE=true>, the decode compared, the
size estimate ``32 * bits(max - min) + exceptions * 80``).  Two wrappers
shape its input for the two planning levels:

* ``first_level_scores_f64(samples [R, V, 32])``: all 190 pairs of
  ``ops.alp.ef_pairs_arrays`` on each sampled vector, for any V;
* ``second_level_scores_f64(strides [n, 32], combos [n, 5, 2], k_count)``:
  each vector's candidates on its 32-value stride.

``score_pairs_f32`` and its wrappers ``first_level_scores_f32`` (66 pairs)
and ``second_level_scores_f32`` are the float32 twins, after the float
search encode_value32_safe (alpcore.cpp:656-706: an "impossible" scaled
value gets n = INT32_MIN and is compared like any other, so -0.0 counts
with n = INT32_MIN at f >= 1; the decode compared as a float; exceptions
cost 48 bits).  The JAX package's TPU scorer replaces special values
first and so departs from the host search on -0.0; the port follows the
host.

A CUDA tensor goes through the hand-written kernels in ``csrc/score.cu``
on the current stream of its card, without a synchronise; a CPU tensor
through the plain versions beside them.  ``LAUNCHES`` counts kernel launches;
plain runs do not count.
"""

from __future__ import annotations

import functools

import torch

from .. import tracing
from .. import constants as C
from ..ops.alp import bit_width_of, ef_pairs_arrays
from .encode import (INT32_MAX, INT32_MIN, INT64_MAX, INT64_MIN,
                     check_pairs, decoded_bits, decodes_to32, round_cast,
                     round_cast32, tables)
from .falp import _check, _device_kind, _launch, _ptr

LAUNCHES = tracing.Counters("alp.launch.", (
    "score_pairs_f64", "score_pairs_f32"))
SAMPLES = C.SAMPLES_PER_VECTOR
EXC_BITS = C.DOUBLE.exception_size + C.EXCEPTION_POSITION_SIZE
EXC_BITS32 = C.FLOAT.exception_size + C.EXCEPTION_POSITION_SIZE


reset_launches = LAUNCHES.reset


def score_plain(samples, ef, k_count=None) -> tuple:
    """Plain version of K11: (est, non_exc), int32 [n, C]."""
    t = tables(samples.device)
    e, f = ef[..., 0].to(torch.int64), ef[..., 1].to(torch.int64)
    v = samples[:, None, :]                                   # [n, 1, 32]
    s = (v * t.exp[e][..., None]) * t.frac[f][..., None]     # [n, C, 32]
    sb = s.view(torch.int64)
    impossible = (((sb & 0x7FF0000000000000) == 0x7FF0000000000000)
                  | (s > t.upper) | (s < -t.upper) | (sb == INT64_MIN))
    n = round_cast(s, t.magic)
    dec = decoded_bits(n, t.fact[f][..., None], t.frac[e][..., None])
    ok = ~impossible & (dec == v.view(torch.int64))
    non_exc = ok.sum(dim=-1, dtype=torch.int32)
    mx = torch.where(ok, n, INT64_MIN).amax(dim=-1)
    mn = torch.where(ok, n, INT64_MAX).amin(dim=-1)
    est = SAMPLES * bit_width_of(mx - mn) + (SAMPLES - non_exc) * EXC_BITS
    return _live(est.to(torch.int32), non_exc, ef, k_count)


def score_plain_f32(samples, ef, k_count=None) -> tuple:
    """Plain version of K14: (est, non_exc), int32 [n, C]."""
    t = tables(samples.device, C.FLOAT)
    e, f = ef[..., 0, None].to(torch.int64), ef[..., 1, None].to(torch.int64)
    v = samples[:, None, :]                                   # [n, 1, 32]
    s = (v * t.exp[e]) * t.frac[f]                            # [n, C, 32]
    wide = s.to(torch.float64)
    impossible = (~torch.isfinite(s) | (wide > C.ENCODING_UPPER_LIMIT)
                  | (wide < -C.ENCODING_UPPER_LIMIT)
                  | (s.view(torch.int32) == INT32_MIN))
    n = torch.where(impossible, INT32_MIN, round_cast32(s, t.magic))
    ok = decodes_to32(n, e, f, v, t)
    non_exc = ok.sum(dim=-1, dtype=torch.int32)
    mx = torch.where(ok, n, INT32_MIN).amax(dim=-1).to(torch.int64)
    mn = torch.where(ok, n, INT32_MAX).amin(dim=-1).to(torch.int64)
    delta = (mx - mn) & 0xFFFFFFFF                  # (max - min) mod 2^32
    est = SAMPLES * bit_width_of(delta) + (SAMPLES - non_exc) * EXC_BITS32
    return _live(est.to(torch.int32), non_exc, ef, k_count)


def _live(est, non_exc, ef, k_count) -> tuple:
    """Candidates past a segment's k_count read 0."""
    if k_count is None:
        return est, non_exc
    live = (torch.arange(ef.shape[1], device=est.device)[None, :]
            < k_count[:, None])
    return torch.where(live, est, 0), torch.where(live, non_exc, 0)


def _score(samples, ef, k_count, tc, checked) -> tuple:
    f64 = tc is C.DOUBLE
    n = samples.shape[0]
    device = samples.device
    _check("samples", samples, torch.float64 if f64 else torch.float32,
           (n, SAMPLES), device)
    if ef.dim() != 3 or ef.shape[0] not in (1, n) or ef.shape[2] != 2:
        raise ValueError(f"ef must be [n or 1, C, 2], got {tuple(ef.shape)}")
    _check("ef", ef, torch.int32, ef.shape, device)
    if checked:
        check_pairs("ef", ef, tc)
    n_cand = ef.shape[1]
    if k_count is not None:
        _check("k_count", k_count, torch.int32, (n,), device)
    if _device_kind(samples) == "cpu":
        return (score_plain if f64 else score_plain_f32)(samples, ef,
                                                         k_count)
    est = torch.empty((n, n_cand), dtype=torch.int32, device=device)
    non_exc = torch.empty_like(est)
    name = "score_pairs_f64" if f64 else "score_pairs_f32"
    _launch(name, device, _ptr(samples), _ptr(ef), int(ef.shape[0] != 1),
            n_cand, _ptr(k_count), n, *tables(device, tc).pointers(),
            EXC_BITS if f64 else EXC_BITS32, _ptr(est), _ptr(non_exc))
    LAUNCHES[name] += 1
    return est, non_exc


@tracing.kernel
def score_pairs_f64(samples, ef, k_count=None, *, checked=True) -> tuple:
    """K11.  samples: float64 [n, 32], one segment per row; ef: int32
    [n, C, 2] candidate pairs (e, f) of each segment, or [1, C, 2] shared
    by all; k_count: int32 [n] or None, the candidates of a segment past
    its count are not scored and read 0.  Returns (est, non_exc), int32
    [n, C].  ``checked=False`` skips the synchronising read of the pairs'
    range, for pairs that lie in the tables by construction."""
    return _score(samples, ef, k_count, C.DOUBLE, checked)


@tracing.kernel
def score_pairs_f32(samples, ef, k_count=None, *, checked=True) -> tuple:
    """K14, the float32 twin of K11: samples float32 [n, 32], pairs in
    0..10."""
    return _score(samples, ef, k_count, C.FLOAT, checked)


def _all_pairs(tc, device) -> torch.Tensor:
    return _pairs_on(tc is C.DOUBLE, str(device))


@functools.cache
def _pairs_on(f64: bool, device: str) -> torch.Tensor:
    """The [1, P, 2] pairs, uploaded once a device (an upload syncs)."""
    es, fs = ef_pairs_arrays(C.DOUBLE if f64 else C.FLOAT)
    pairs = torch.stack([torch.from_numpy(es), torch.from_numpy(fs)], -1)
    return pairs[None].to(device)


def first_level_scores_f64(samples, *, checked=True) -> tuple:
    """samples: float64 [R, V, 32], V sampled vectors of R rowgroups.
    Returns (est, non_exc), int32 [R, V, P] over the P pairs of
    ``ef_pairs_arrays`` (feed ``ops.alp.first_level_vote``)."""
    R, V, _ = samples.shape
    est, ne = score_pairs_f64(samples.reshape(R * V, SAMPLES),
                              _all_pairs(C.DOUBLE, samples.device),
                              checked=checked)
    return est.reshape(R, V, -1), ne.reshape(R, V, -1)


def first_level_scores_f32(samples, *, checked=True) -> tuple:
    """The float32 twin of ``first_level_scores_f64``: samples float32
    [R, V, 32]; P = 66 pairs."""
    R, V, _ = samples.shape
    est, ne = score_pairs_f32(samples.reshape(R * V, SAMPLES),
                              _all_pairs(C.FLOAT, samples.device),
                              checked=checked)
    return est.reshape(R, V, -1), ne.reshape(R, V, -1)


def second_level_scores_f64(strides, combos, k_count, *,
                            checked=True) -> torch.Tensor:
    """strides: float64 [n, 32], each vector's 32-value stride; combos:
    int32 [n, 5, 2] its candidates (e, f); k_count: int32 [n], how many
    are real.  Returns est, int32 [n, 5] (feed ``ops.alp.accept_scan``)."""
    return score_pairs_f64(strides, combos, k_count, checked=checked)[0]


def second_level_scores_f32(strides, combos, k_count, *,
                            checked=True) -> torch.Tensor:
    """The float32 twin of ``second_level_scores_f64``."""
    return score_pairs_f32(strides, combos, k_count, checked=checked)[0]
