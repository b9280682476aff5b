"""The port's four decode kernels vs the JAX kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; here it is held
against the Pallas kernel it replaces, run as the JAX package's own tests
run it (interpret mode), bucket by bucket through both decode plans, before
the exception scatter.  Tolerance: none; bits must be equal.

* K1 ``falp_decode_f64`` against every f64 variant the JAX plan picks:
  gen (with and without the FACT multiply, with wrapping products), small,
  mid, mid64, midc96 (both also on all-negative buckets) and const.  The
  columns are built from chosen integers so that each variant is picked.
* K2 ``falp_decode_f32``, K3 ``rd_decode_dict_f64``, K4
  ``rd_decode_dict_f32`` on compressed route columns.  For K3/K4 exception
  slots are left out: there the dictionary lookup is a placeholder that the
  scatter overwrites, and the two plans place different ones.

``tests/test_torch_cuda.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alp_tpu import constants as jconstants
from alp_tpu import container as jcontainer
from alp_tpu.kernels import decode as jdecode
from alp_tpu.oracle import core as ocore
from alp_tpu.oracle import fastlanes as ofl

from alp_tpu_torch import constants as C
from alp_tpu_torch import interop
from alp_tpu_torch.columns import route_columns
from alp_tpu_torch.kernels import decode, falp

N = 8                                    # vectors per synthetic column


def _alp_column(ints: np.ndarray, fac: int, exp: int):
    """A JAX-package f64 ALP column holding ``ints`` [n, 1024] as the
    encoded integers of every vector, at one (fac, exp)."""
    n = ints.shape[0]
    base = ints.min(axis=1)
    delta = ints.view(np.uint64) - base.view(np.uint64)[:, None]
    dmax = delta.max(axis=1)
    bw = np.array([int(d).bit_length() for d in dmax], np.uint8)
    n_rg = -(-n // C.N_VECTORS_PER_ROWGROUP)
    return jcontainer.CompressedColumn(
        dtype=np.dtype(np.float64), n_values=n * 1024, n_vectors=n,
        rg_scheme=np.full(n_rg, C.SCHEME_ALP, np.uint8),
        rd_dict=np.zeros((n_rg, 8), np.uint16),
        rd_dict_size=np.zeros(n_rg, np.uint8),
        rd_left_bw=np.zeros(n_rg, np.uint8),
        rd_right_bw=np.zeros(n_rg, np.uint8),
        fac=np.full(n, fac, np.uint8), exp=np.full(n, exp, np.uint8),
        bit_width=bw, base=base.astype(np.int64),
        exc_count=np.zeros(n, np.uint16),
        packed=[ofl.ffor_pack(ints[i], int(bw[i]), base[i])
                for i in range(n)],
        left_packed=[np.empty(0, np.uint16)] * n,
        exc_values=[np.empty(0, np.float64)] * n,
        exc_positions=[np.empty(0, np.uint16)] * n,
        enc_max=dmax.astype(np.uint64))


def _fields(col):
    return {f.name: getattr(col, f.name) for f in dataclasses.fields(col)}


def _unpatched(jcol):
    """Per-vector bits before the exception scatter: (JAX kernels, port
    kernels through their wrappers on the CPU, JAX variants used)."""
    f64 = jcol.dtype == np.float64
    ut = np.uint64 if f64 else np.uint32
    ref = np.zeros((jcol.n_vectors, 1024), ut)
    jplan = jdecode.build_plan(jcol)
    for g in jplan.groups:
        out = jdecode.group_decode(g, jcol.dtype)(*jdecode.group_arrays(g))
        vals = (jdecode._planes_to_values_f64(*out) if f64
                else jdecode._planes_to_values_f32(out))
        ref[g.vec_indices] = np.asarray(vals)[:g.n_vectors]
    col = interop.column_from_arrays(_fields(jcol))
    plan = decode.build_plan(col, "cpu")
    out = torch.zeros((col.n_vectors, 1024),
                      dtype=torch.float64 if f64 else torch.float32)
    for bucket in plan.buckets:
        plan.launch(bucket, out)
    return ref, out.numpy().view(ut), {g.variant for g in jplan.groups}


# name: (integers from rng, fac, exp, the JAX variant it must pick)
K1_CASES = {
    "const": (lambda r: np.full((N, 1024), 7, np.int64), 0, 1, "const"),
    "small": (lambda r: r.integers(0, 2**20, (N, 1024)) + 5, 0, 2, "small"),
    "mid": (lambda r: r.integers(0, 1000, (N, 1024)), 14, 14, "mid"),
    "mid64": (lambda r: r.integers(0, 2**40, (N, 1024)), 1, 14, "mid64"),
    "mid64_allneg": (lambda r: -r.integers(1, 2**40, (N, 1024)), 1, 14,
                     "mid64"),
    "midc96": (lambda r: r.integers(0, 2**38, (N, 1024)), 6, 16, "midc96"),
    "midc96_allneg": (lambda r: -r.integers(1, 2**38, (N, 1024)), 6, 16,
                      "midc96"),
    "gen_fact1": (lambda r: r.integers(-2**59, 2**59, (N, 1024)), 0, 0,
                  "gen"),
    "gen_wrapping": (lambda r: r.integers(-2**62, 2**62, (N, 1024)), 3, 5,
                     "gen"),
    "gen_bw64": (lambda r: r.integers(-2**63, 2**63 - 1, (N, 1024)), 0, 3,
                 "gen"),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_equals_every_jax_f64_variant(case):
    make, fac, exp, variant = K1_CASES[case]
    ints = make(np.random.default_rng(len(case))).astype(np.int64)
    ref, got, variants = _unpatched(_alp_column(ints, fac, exp))
    assert variant in variants
    assert np.array_equal(got, ref)
    # and the reference formula (oracle/core.py:84-97)
    expect = ocore.decode_value(ints, fac, exp, jconstants.DOUBLE)
    assert np.array_equal(got, expect.view(np.uint64))


@pytest.fixture(scope="module")
def route_jax_columns():
    cols = route_columns(np.random.default_rng(3),
                         2 * C.N_VECTORS_PER_ROWGROUP)
    return {name: jcontainer.compress(cols[name])
            for name in ("f32_alp", "f64_alp_rd", "f32_alp_rd",
                         "f64_mixed_alp_rd", "bench_bw42_nyc29")}


def _exception_mask(jcol):
    mask = np.zeros((jcol.n_vectors, 1024), bool)
    for v in range(jcol.n_vectors):
        mask[v, jcol.exc_positions[v].astype(np.int64)] = True
    return mask


@pytest.mark.parametrize("name,kernel", [
    ("f32_alp", "falp_decode_f32"),
    ("bench_bw42_nyc29", "falp_decode_f64"),
    ("f64_alp_rd", "rd_decode_dict_f64"),
    ("f32_alp_rd", "rd_decode_dict_f32"),
    ("f64_mixed_alp_rd", "rd_decode_dict_f64"),
])
def test_k2_k3_k4_equal_jax(name, kernel, route_jax_columns):
    jcol = route_jax_columns[name]
    ref, got, _ = _unpatched(jcol)
    vec_rg = np.arange(jcol.n_vectors) // C.N_VECTORS_PER_ROWGROUP
    rd = (jcol.rg_scheme[vec_rg] == C.SCHEME_ALP_RD)[:, None]
    keep = ~(rd & _exception_mask(jcol))
    assert keep.sum() > 0.5 * keep.size
    assert np.array_equal(got[keep], ref[keep])
    plan = decode.build_plan(interop.column_from_arrays(_fields(jcol)), "cpu")
    assert any(_kernel_name(plan, b) == kernel for b in plan.buckets)


def _kernel_name(plan, bucket):
    kind = "falp_decode" if bucket.scheme == C.SCHEME_ALP else "rd_decode_dict"
    return f"{kind}_{'f64' if plan.f64 else 'f32'}"


def _k1_args(n=2, bw=5):
    return (torch.zeros((n, bw * 16), dtype=torch.int64), bw,
            torch.zeros(n, dtype=torch.int64),
            torch.ones(n, dtype=torch.int64),
            torch.ones(n, dtype=torch.float64))


def test_wrapper_on_cpu_counts_no_launch():
    falp.reset_launches()
    out = falp.falp_decode_f64(*_k1_args())
    assert out.shape == (2, 1024) and (out == 0).all()
    assert all(v == 0 for v in falp.LAUNCHES.values())


def test_wrapper_writes_rows_of_out():
    packed, bw, base, fact, frac = _k1_args()
    base += torch.tensor([3, 4])
    out = torch.full((5, 1024), -1.0, dtype=torch.float64)
    falp.falp_decode_f64(packed, bw, base, fact, frac, out=out,
                         rows=torch.tensor([4, 1]))
    assert (out[4] == 3).all() and (out[1] == 4).all()
    assert (out[[0, 2, 3]] == -1).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "bw", "contiguous",
                                 "rows_without_out"])
def test_wrapper_rejects_bad_arguments(bad):
    packed, bw, base, fact, frac = _k1_args()
    kw = {}
    if bad == "dtype":
        base = base.to(torch.int32)
    elif bad == "shape":
        packed = packed[:, :-1].contiguous()
    elif bad == "bw":
        bw = 65
    elif bad == "contiguous":
        packed = torch.zeros((bw * 16, 2), dtype=torch.int64).t()
    else:
        kw["rows"] = torch.tensor([0, 1])
    with pytest.raises((TypeError, ValueError)):
        falp.falp_decode_f64(packed, bw, base, fact, frac, **kw)


def test_rd_wrapper_dtype_checked():
    with pytest.raises(TypeError):
        falp.rd_decode_dict_f64(torch.zeros((1, 16 * 48), dtype=torch.int32),
                                48, torch.zeros((1, 64), dtype=torch.int16),
                                1, torch.zeros((1, 8), dtype=torch.int16),
                                torch.ones(1, dtype=torch.int32))
