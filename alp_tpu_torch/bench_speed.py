"""Per-kernel speed rows of the port on the card.

    python -m alp_tpu_torch.bench_speed

Counterpart of ``scripts/bench_speed.py``: one line a row on standard
output, ``(name, iters, value, unit)``, each timed by
``benchlib.loop_bench`` (CUDA events, best of 2 passes of ``iters``
iterations, the carry folded into one input of the kernel), in GB/s of
the decoded (or, for the encode rows, the input) bytes.  The rows keep
the reference's names where the port has the kernel:

* ``falp_f64_bw{8..64}``, ``falp_f64_const_bw0``: K1 on 32,768 vectors
  (256 MiB of doubles) of random packed words, FACT 1, FRAC 1e-9;
* ``unffor_f64_bw16``, ``unffor_f64_bw52``, ``unffor_f32_bw30``: K22;
* ``rd_decode_f64_rbw52``, ``rd_decode_f32_rbw24``: K21, random right
  parts and left parts of 16 (f64) and 8 (f32) bits;
* ``falp_sum_fused_f64_bw16``: K20; ``falp_sum_exact_fused_f64_bw16``: K7;
* ``falp_f32_bw10``, ``falp_f32_bw20``: K2 on 65,536 vectors (256 MiB);
* ``encode_f64_without_sampling``: K9 on 128 MiB of doubles at one
  (e, f) a vector; ``encode_f32_kernel``: K12 on 128 MiB of floats;
* ``key_extremes`` (K16) over a 64 MiB compressed column and
  ``key_extremes_bits_f64`` (K23) over its decoded bits;
* ``e2e_sum_query_64MiB``, ``e2e_exact_sum_query_64MiB``: the loop steps
  ``engine.make_sum_step`` and ``make_exact_sum_step`` on that column;
  ``e2e_filter_count_query_64MiB``, ``e2e_topk_query_64MiB`` and
  ``e2e_histogram_query_64MiB``: ``make_filter_step`` (-15 <= v <= 25),
  ``make_topk_step`` (k = 10) and ``make_histogram_step`` (6 edges), the
  arguments of ``scripts/bench_e2e.py``; ``e2e_groupby_query_64MiB`` and
  ``e2e_groupby_sorted_query_64MiB``: ``make_groupby_step`` at 16 groups
  of random keys (K19 over the column) and of the same keys sorted (K18,
  K19 on the vectors a boundary crosses).

Random bits come from a ``torch.Generator`` seeded on the card.  The card's
name and power limit go to standard error first.  It writes no file, and
without a card it exits nonzero.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import benchlib, columns, engine
from . import constants as C
from .bench import card_line
from .container import compress
from .engine import LoopStep
from .kernels import decode
from .kernels import encode as kenc
from .kernels import exact_sum as kes
from .kernels import falp as kfalp
from .kernels import ffor as kffor
from .kernels import group as kgroup
from .ops.fastlanes import unffor_unpack

VECTORS = 32 * 1024            # 256 MiB of doubles, as the reference's G
ITERS = 30
V = C.VECTOR_SIZE


def _carry_into(t: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
    """``t`` with the carry XORed in (a per-vector metadata tensor)."""
    return t ^ carry.to(t.dtype)


def _first_word(out: torch.Tensor) -> torch.Tensor:
    bits = out.view(torch.int64 if out.element_size() == 8 else torch.int32)
    return bits.reshape(-1)[0].to(torch.int64)


def rows(dev, seed: int = 0, vectors: int = VECTORS, check=None) -> list:
    """Run every row on ``dev``; returns the (name, iters, value, unit)
    tuples.  ``vectors`` scales the synthetic inputs (f32 rows take twice
    as many vectors, the encode rows half); the e2e column is the
    city-temperature profile over one rowgroup, tiled to a quarter of
    ``vectors`` (at least 16, for the top-k).  ``check``, if given, is
    called after each row as ``check(name, step, args, plain)`` while the
    row's inputs live: ``plain`` is the row's step with the kernel
    replaced by its plain version (``step.result`` and ``plain.result`` at
    carry 0 must agree by bits), None for a row without one."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def bits(shape, dtype):
        lo = torch.iinfo(dtype)
        return torch.empty(shape, dtype=dtype, device=dev).random_(
            lo.min, lo.max, generator=g)

    def full(n, value, dtype):
        return torch.full((n,), value, dtype=dtype, device=dev)

    res = []

    def row(name, step, args, iters, nbytes, plain=None):
        dt = benchlib.loop_bench(step, args, iters, device=dev)
        res.append((name, iters, nbytes / dt / 1e9, "GB/s"))
        print(res[-1], flush=True)
        if check is not None:
            check(name, step, args, plain)

    N, N32 = vectors, 2 * vectors
    out_bytes, out_bytes32 = N * V * 8, N32 * V * 4
    zero64, one64 = full(N, 0, torch.int64), full(N, 1, torch.int64)
    frac = full(N, 1e-9, torch.float64)

    def falp_step(bw):
        # at bit width 0 the decode is the base itself, so an XOR chain
        # would cancel: the carry ADDs there (bench.py:86-95)
        def result(carry, packed, base):
            base = base + carry if bw == 0 else base ^ carry
            return kfalp.falp_decode_f64(packed, bw, base, one64, frac)

        def fold(out, carry):
            return carry + _first_word(out) if bw == 0 else \
                carry ^ _first_word(out)
        return LoopStep(result, fold)

    for bw in (8, 16, 24, 32, 42, 52, 64):
        row(f"falp_f64_bw{bw}", falp_step(bw),
            (bits((N, 16 * bw), torch.int64), zero64), ITERS, out_bytes)
    row("falp_f64_const_bw0", falp_step(0),
        (bits((N, 0), torch.int64), bits((N,), torch.int64)), ITERS,
        out_bytes)

    def unffor_step(fn):
        return LoopStep(lambda c, p, bw, b: fn(p, bw, _carry_into(b, c)),
                        lambda out, c: c ^ _first_word(out))

    unffor_plain = unffor_step(lambda p, bw, b: unffor_unpack(p, b, bw))
    for bw in (16, 52):
        row(f"unffor_f64_bw{bw}", unffor_step(kffor.unffor),
            (bits((N, 16 * bw), torch.int64), bw, zero64), ITERS, out_bytes,
            unffor_plain)
    row("unffor_f32_bw30", unffor_step(kffor.unffor),
        (bits((N32, 32 * 30), torch.int32), 30, full(N32, 0, torch.int32)),
        ITERS, out_bytes32, unffor_plain)

    def glue_step(fn, rbw):
        def result(carry, right, left):
            left[:1] ^= carry.to(torch.int32)   # one vector's left parts
            return fn(right, rbw, left)
        return LoopStep(result, lambda out, c: c ^ _first_word(out))

    row("rd_decode_f64_rbw52", glue_step(kfalp.rd_glue_f64, 52),
        (bits((N, 16 * 52), torch.int64), bits((N, V), torch.int32) & 0xFFFF),
        ITERS, out_bytes, glue_step(kfalp.rd_glue_plain, 52))
    row("rd_decode_f32_rbw24", glue_step(kfalp.rd_glue_f32, 24),
        (bits((N32, 32 * 24), torch.int32), bits((N32, V), torch.int32) & 0xFF),
        ITERS, out_bytes32, glue_step(kfalp.rd_glue_plain, 24))

    def vsum_step(fn):
        return LoopStep(lambda c, p, b: fn(p, 16, b ^ c, one64, frac),
                        lambda out, c: c ^ _first_word(out))

    packed16 = bits((N, 16 * 16), torch.int64)
    row("falp_sum_fused_f64_bw16", vsum_step(kfalp.variant_sum_f64),
        (packed16, zero64), ITERS, out_bytes,
        vsum_step(kfalp.variant_sum_plain))
    rows64 = torch.arange(N, device=dev)
    no_exc = (torch.zeros(N + 1, dtype=torch.int64, device=dev),
              torch.zeros(0, dtype=torch.int64, device=dev),
              torch.zeros(0, dtype=torch.int64, device=dev))
    row("falp_sum_exact_fused_f64_bw16", LoopStep(
        lambda c, p, b: kes.falp_decode_f64_exact_sum(
            p, 16, b ^ c, one64, frac, rows64, *no_exc, N * V),
        lambda out, c: c ^ out.sum()), (packed16, zero64), ITERS, out_bytes)

    zero32, one32 = full(N32, 0, torch.int32), full(N32, 1, torch.int32)
    frac32 = full(N32, 0.01, torch.float32)
    for bw in (10, 20):
        row(f"falp_f32_bw{bw}", LoopStep(
            lambda c, p, b, bw=bw: kfalp.falp_decode_f32(
                p, bw, _carry_into(b, c), one32, frac32),
            lambda out, c: c ^ _first_word(out)),
            (bits((N32, 32 * bw), torch.int32), zero32), ITERS, out_bytes32)

    def encode_step(fn, n, e, f):
        es, fs = full(n, e, torch.int32), full(n, f, torch.int32)

        def result(carry, values):
            head = values.view(torch.int64 if values.element_size() == 8
                               else torch.int32)[:1]
            head ^= carry.to(head.dtype)         # one vector's values
            return fn(values, es, fs, stats=False)
        return LoopStep(result, lambda out, c: c ^ _first_word(out[0]))

    Ne = N // 2                                   # 128 MiB of doubles
    v64 = torch.empty((Ne, V), dtype=torch.float32, device=dev).uniform_(
        1.0, 100.0, generator=g).to(torch.float64)
    row("encode_f64_without_sampling",
        encode_step(kenc.alp_encode_f64, Ne, 14, 12), (v64,), 15, Ne * V * 8)
    del v64
    v32 = (bits((N, V), torch.int32) & 0x3FFFFFFF).view(torch.float32)
    row("encode_f32_kernel", encode_step(kenc.alp_encode_f32, N, 4, 2),
        (v32,), 20, N * V * 4)
    del v32

    # a real compressed column: the city-temperature profile, 64 MiB
    data = columns.route_columns(np.random.default_rng(seed),
                                 columns.RG_VECTORS)
    col = columns.tile_column(compress(data["bench_bw11_city_temperature"]),
                              max(16, N // 4))
    plan = decode.build_plan(col, dev)
    col_bytes = plan.n_vectors * V * 8
    row("key_extremes", LoopStep(
        lambda c, plan: engine.vector_extremes(engine.carried(plan, c)),
        lambda out, c: c ^ out[0, 0]), (plan,), ITERS, col_bytes)

    def extremes_step(fn):
        return LoopStep(lambda c, b: fn(b), lambda out, c: c ^ out[0, 0])

    dbits = plan.run().view(torch.int64)
    row("key_extremes_bits_f64", extremes_step(kgroup.key_extremes_bits_f64),
        (dbits,), ITERS, col_bytes,
        extremes_step(kgroup.key_extremes_bits_plain))
    del dbits
    row("e2e_sum_query_64MiB", *engine.make_sum_step(plan), 20, col_bytes)
    row("e2e_exact_sum_query_64MiB", *engine.make_exact_sum_step(plan), 20,
        col_bytes)
    row("e2e_filter_count_query_64MiB",
        *engine.make_filter_step(plan, -15.0, 25.0), 20, col_bytes)
    row("e2e_topk_query_64MiB", *engine.make_topk_step(plan, 10), 20,
        col_bytes)
    row("e2e_histogram_query_64MiB", *engine.make_histogram_step(
        plan, [-40.0, -15.0, 0.0, 10.0, 25.0, 45.0]), 20, col_bytes)
    keys = np.random.default_rng(3).integers(0, 16, col.n_values)
    row("e2e_groupby_query_64MiB",
        *engine.make_groupby_step(col, keys, 16, plan=plan), 20, col_bytes)
    row("e2e_groupby_sorted_query_64MiB",
        *engine.make_groupby_step(col, np.sort(keys), 16, plan=plan), 20,
        col_bytes)
    return res


def main() -> int:
    try:
        dev = decode.resolve_device(None)
    except RuntimeError as e:
        print(f"bench_speed: {e}", file=sys.stderr)
        return 1
    print(f"# {card_line()}", file=sys.stderr)
    rows(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
