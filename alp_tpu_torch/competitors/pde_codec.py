"""PDE (BtrBlocks Pseudodecimal) competitor — behavioral reimplementation.

Counterpart of ``alp_tpu/competitors/pde_codec.py``, host numpy as
there: the same streams, bit counts and decoded bits.

The reference's end-to-end benchmark compares ALP against BtrBlocks'
Pseudodecimal scheme ("PDE": 16.2x slower SCAN than ALP at one thread,
reference publication/tables/table_6.md:7) whose algorithm lives in
reference publication/source_code/bench_end_to_end/btrblocks_copy/
btrblocks/scheme/double/Pseudodecimal.cpp:
per value find the smallest exponent e in [0, 22] such that
``sd = round(v / 10^-e)`` satisfies ``sd * 10^-e == v`` bit-exactly and
``sd`` fits the significant-digit bit budget (31 bits); store the
significand stream (i32), the exponent stream (u8; code 23 marks an
exception patched verbatim), and the patch list.  Decompression is
``sd * 10^-e`` plus patching — exactly ALP's decode multiply without
the per-vector (e, f) adaptivity or FFOR (BtrBlocks cascades generic
integer schemes over the streams instead; this reimplementation keeps
the streams raw, which only *helps* its speed ranking).

Encode is vectorised numpy (setup cost, never benchmarked); decode has
a numpy path here and a native single-core C++ path
(native/competitors.cpp cmp_pde_decode_f64) used for the table-6 speed
rows.
"""

from __future__ import annotations

import numpy as np

MAX_EXPONENT = 22                      # Pseudodecimal.cpp:16
EXCEPTION_CODE = 23                    # Pseudodecimal.cpp:17
SIG_BITS_LIMIT = 31                    # significant_digit_bits_limits

# exact_fractions_of_ten: 10^-e as double (same table ALP's FRAC uses)
FRAC = np.array([float(f"1e-{e}") for e in range(MAX_EXPONENT + 1)],
                np.float64)


def pde_encode(data: np.ndarray):
    """Encode f64 -> (sig i32[n], exp u8[n], patches f64[p]).

    Vectorised mirror of Pseudodecimal.cpp:82-123: smallest exponent
    whose round-trip is bit-exact wins; non-convertible values (incl.
    NaN/inf and > 31-bit significands) become patches with exponent
    code 23 (their sig slot is 0)."""
    v = np.ascontiguousarray(data, np.float64)
    n = len(v)
    sig = np.zeros(n, np.int32)
    exp = np.full(n, EXCEPTION_CODE, np.uint8)
    todo = np.ones(n, bool)
    bits = v.view(np.uint64)
    finite = ((bits >> np.uint64(52)) & np.uint64(0x7FF)) != np.uint64(
        0x7FF)
    todo &= finite
    lim = float(2 ** (SIG_BITS_LIMIT - 1) - 1)
    for e in range(MAX_EXPONENT + 1):
        if not todo.any():
            break
        with np.errstate(over="ignore", invalid="ignore"):
            cd = v[todo] / FRAC[e]
            sd = np.round(cd)
            ok = np.abs(sd) <= lim
            # verify through the stored i32 significand (the stream's
            # actual representation, so -0.0 correctly patches)
            si = np.where(ok, sd, 0.0).astype(np.int32)
            ok &= (si.astype(np.float64) * FRAC[e]).view(
                np.uint64) == v[todo].view(np.uint64)
        idx = np.nonzero(todo)[0][ok]
        sig[idx] = si[ok]
        exp[idx] = e
        todo[idx] = False
    patches = v[exp == EXCEPTION_CODE]
    return sig, exp, patches


def pde_decode(sig: np.ndarray, exp: np.ndarray,
               patches: np.ndarray) -> np.ndarray:
    """Numpy decode: ``sig * 10^-e`` + verbatim patches
    (Pseudodecimal.cpp decompress loop)."""
    e = np.minimum(exp, EXCEPTION_CODE - 1)
    out = sig.astype(np.float64) * FRAC[e]
    is_p = exp == EXCEPTION_CODE
    out[is_p] = patches
    return out


def pde_bits(data: np.ndarray) -> int:
    """Raw stream cost in bits: 32 (sig) + 8 (exp) per value + 64 per
    patch — a LOWER bound on BtrBlocks' size (its cascade then
    compresses the streams; size is not this codec's comparison axis,
    speed is)."""
    sig, exp, patches = pde_encode(data)
    return sig.size * 32 + exp.size * 8 + patches.size * 64
