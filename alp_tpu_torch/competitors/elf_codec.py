"""Elf codec: erase-based lossless floating-point compression.

Counterpart of ``alp_tpu/competitors/elf_codec.py``, host Python as
there: the same bitstream, bit counts and decoded bits.

Behavioral reimplementation of the Elf reference (Li et al., VLDB 2023)
that the ALP artifact benchmarks as a competitor via its Java build
(reference publication/source_code/extern/elf/, run by
publication/script/master_script.sh:84-85).  Two stages:

1. **Erase** (AbstractElfCompressor.addValue): for a decimal-looking
   double, compute ``alpha`` (fractional decimal digits) and ``beta*``
   (significant digits); mantissa bits below weight ~10^-alpha carry no
   information for decimal recovery, so they are zeroed and a 5-bit
   header ``1 | beta*`` is emitted (values that do not qualify emit a
   single 0 bit and pass through unchanged).
2. **XOR-compress** the erased stream (ElfXORCompressor): Gorilla-style
   XOR with the Chimp leading-zero rounding table and four 2-bit cases
   (00 reuse window / 01 identical / 10 new window <=16 center bits,
   9-bit header / 11 new window, 11-bit header).

The decoder XOR-decodes then restores erased values by decimal rounding
(AbstractElfDecompressor.roundUp): ``v = ceil_or_floor(v' * 10^alpha) /
10^alpha`` with ``alpha = beta* - floor(log10|v'|) - 1``.

Deviations from the Java reference (documented, deliberate):
* values whose derived ``alpha <= 0`` (|v| >= ~1e16 with unreliable
  significant-count) take the uncompressed branch instead of raising
  (the Java code throws IllegalArgumentException there);
* NaN cannot round-trip: the format's end-of-stream sentinel IS the
  canonical qNaN bit pattern (ElfXORCompressor.END_SIGN), so the erase
  stage canonicalises NaN exactly like the Java code and the stream
  must not contain interior NaNs.

``elf_bits`` is the exact bit-cost model (validated against the scalar
round-trip); ``elf_roundtrip`` encodes to a real bitstream, decodes,
and verifies bit-exact recovery.
"""

from __future__ import annotations

import math

import numpy as np

# f[alpha] = ceil(alpha * log2(10)) lookup (AbstractElfCompressor.f)
_F_ALPHA = [0, 4, 7, 10, 14, 17, 20, 24, 27, 30, 34, 37, 40, 44, 47, 50,
            54, 57, 60, 64, 67]
_LOG2_10 = math.log2(10.0)
_END_SIGN = 0x7FF8000000000000          # Double.doubleToLongBits(NaN)

# ElfXORCompressor.leadingRepresentation / leadingRound
_LEAD_REPR = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
              3, 3, 4, 4, 5, 5, 6, 6] + [7] * 41
_LEAD_ROUND = [0, 0, 0, 0, 0, 0, 0, 0, 8, 8, 8, 8, 12, 12, 12, 12,
               16, 16, 18, 18, 20, 20, 22, 22] + [24] * 41
_LEAD_DECODE = [0, 8, 12, 16, 18, 20, 22, 24]


def _f_alpha(alpha: int) -> int:
    if alpha < len(_F_ALPHA):
        return _F_ALPHA[alpha]
    return math.ceil(alpha * _LOG2_10)


def _pow10(i: int) -> float:
    """Java get10iP semantics: table below 1e21, parsed decimal above
    (both are the correctly-rounded double for 10^i)."""
    return float(f"1e{i}")


def _significant_count(v: float, sp: int) -> int:
    """AbstractElfCompressor.getSignificantCount, exact Java semantics."""
    i = 1 if sp >= 0 else -sp
    temp = v * _pow10(i)
    # Java (long)temp != temp: non-integral, or out of int64 range
    while not (abs(temp) < 2 ** 63 and temp == math.floor(temp)):
        i += 1
        if i > 25:
            # v * 10^i only grows: Java's loop would never terminate
            # (|v| >~ 2^63); treat as not-shortest, like the /10 check
            return 17
        temp = v * _pow10(i)
    if temp / _pow10(i) != v:
        return 17
    return sp + i + 1


def _alpha_beta_star(v: float):
    """(alpha, beta*) of AbstractElfCompressor.getAlphaAndBetaStar."""
    av = abs(v)
    log10v = math.log10(av)
    sp = math.floor(log10v)
    beta = _significant_count(av, sp)
    alpha = beta - sp - 1
    beta_star = 0 if (av < 1 and sp == log10v) else beta
    return alpha, beta_star


def _erase_one(v: float):
    """One value through the erase stage.

    Returns (header_bits, header_nbits, vprime_u64): the flag/beta*
    header (1 or 5 bits) and the possibly-erased bit pattern.
    """
    bits = np.float64(v).view(np.uint64)
    vlong = int(bits)
    if v == 0.0 or math.isinf(v):
        return 0, 1, vlong
    if math.isnan(v):
        return 0, 1, _END_SIGN
    alpha, beta_star = _alpha_beta_star(v)
    if alpha <= 0:
        # Java would throw in getFAlpha; treat as uncompressible
        return 0, 1, vlong
    e = (vlong >> 52) & 0x7FF
    g_alpha = _f_alpha(alpha) + e - 1023
    erase_bits = 52 - g_alpha
    mask = (0xFFFFFFFFFFFFFFFF << (erase_bits & 63)) & 0xFFFFFFFFFFFFFFFF
    delta = (~mask) & vlong & 0xFFFFFFFFFFFFFFFF
    if beta_star < 16 and delta != 0 and erase_bits > 4:
        return beta_star | 0x10, 5, vlong & mask
    return 0, 1, vlong


def _lz64(x: int) -> int:
    return 64 - x.bit_length() if x else 64


def _tz64(x: int) -> int:
    return (x & -x).bit_length() - 1 if x else 64


class _BitWriter:
    """MSB-first bit writer with incremental byte flushing (keeping the
    whole stream in one Python int would make encode O(n^2))."""

    def __init__(self):
        self.chunks = []
        self.acc = 0
        self.nacc = 0
        self.total = 0

    def put(self, v: int, n: int):
        if n == 0:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nacc += n
        self.total += n
        if self.nacc >= 256:   # keep the accumulator small:
            # every put shifts the whole acc, so its size is
            # the constant factor of the O(n) encode
            keep = self.nacc % 8
            nbytes = (self.nacc - keep) // 8
            self.chunks.append(
                (self.acc >> keep).to_bytes(nbytes, "big"))
            self.acc &= (1 << keep) - 1
            self.nacc = keep

    def flush(self):
        pad = (-self.nacc) % 8
        acc = self.acc << pad
        self.chunks.append(acc.to_bytes((self.nacc + pad) // 8, "big"))
        payload = b"".join(self.chunks)
        self.chunks = [payload]
        self.acc, self.nacc = 0, 0
        return payload, self.total


class _Reader:
    """MSB-first bit reader with an incrementally refilled window (one
    whole-stream big integer would make decode O(n^2))."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0                      # next byte to pull in
        self.acc = 0
        self.nacc = 0

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        while self.nacc < n:
            step = min(16, len(self.data) - self.pos)
            if step <= 0:                 # past the end: zero-fill
                self.acc <<= (n - self.nacc)
                self.nacc = n
                break
            self.acc = ((self.acc << (8 * step))
                        | int.from_bytes(
                            self.data[self.pos:self.pos + step], "big"))
            self.pos += step
            self.nacc += 8 * step
        self.nacc -= n
        out = (self.acc >> self.nacc) & ((1 << n) - 1)
        self.acc &= (1 << self.nacc) - 1
        return out


class _ElfXorEncoder:
    """ElfXORCompressor, exact bit format."""

    def __init__(self, w: _BitWriter):
        self.w = w
        self.first = True
        self.stored = 0
        self.lead = 1 << 30
        self.trail = 1 << 30

    def add(self, value: int):
        if self.first:
            self.first = False
            self.stored = value
            tz = _tz64(value)
            self.w.put(tz, 7)
            if 64 - tz:
                self.w.put(value >> tz, 64 - tz)
            return
        xor = self.stored ^ value
        if xor == 0:
            self.w.put(1, 2)
            return
        lead = _LEAD_ROUND[_lz64(xor)]
        trail = _tz64(xor)
        if lead == self.lead and trail >= self.trail:
            center = 64 - self.lead - self.trail
            self.w.put(0, 2)
            self.w.put(xor >> self.trail, center)
        else:
            self.lead = lead
            self.trail = trail
            center = 64 - lead - trail
            if center <= 16:
                self.w.put((((0x2 << 3) | _LEAD_REPR[lead]) << 4)
                           | (center & 0xF), 9)
            else:
                self.w.put((((0x3 << 3) | _LEAD_REPR[lead]) << 6)
                           | (center & 0x3F), 11)
            self.w.put(xor >> trail, center)
        self.stored = value

    def close(self):
        self.add(_END_SIGN)
        self.w.put(0, 1)


class _ElfXorDecoder:
    """ElfXORDecompressor, exact bit format."""

    def __init__(self, r: _Reader):
        self.r = r
        self.first = True
        self.stored = 0
        self.lead = 0
        self.trail = 0
        self.done = False

    def next(self):
        if self.done:
            return None
        if self.first:
            self.first = False
            tz = self.r.get(7)
            v = self.r.get(64 - tz) << tz if tz < 64 else 0
            if v == _END_SIGN:
                self.done = True
                return None
            self.stored = v
            return v
        flag = self.r.get(2)
        if flag == 1:
            return self.stored
        if flag == 3:
            lac = self.r.get(9)
            self.lead = _LEAD_DECODE[lac >> 6]
            center = lac & 0x3F or 64
            self.trail = 64 - self.lead - center
        elif flag == 2:
            lac = self.r.get(7)
            self.lead = _LEAD_DECODE[lac >> 4]
            center = lac & 0xF or 16
            self.trail = 64 - self.lead - center
        else:
            center = 64 - self.lead - self.trail
        v = self.stored ^ (self.r.get(center) << self.trail)
        if v == _END_SIGN:
            self.done = True
            return None
        self.stored = v
        return v


def elf_encode(data: np.ndarray):
    """Full Elf encode -> (bytes, total_bits).  f64 only."""
    assert data.dtype == np.float64, "Elf reference is double-precision"
    w = _BitWriter()
    xor = _ElfXorEncoder(w)
    for v in data.tolist():
        hdr, hn, vprime = _erase_one(v)
        w.put(hdr, hn)
        xor.add(vprime)
    xor.close()
    payload, nbits = w.flush()
    return payload, nbits


def elf_decode(payload: bytes, n: int) -> np.ndarray:
    """Inverse of :func:`elf_encode`; returns n doubles."""
    r = _Reader(payload)
    xor = _ElfXorDecoder(r)
    out = np.empty(n, np.float64)
    for k in range(n):
        flag = r.get(1)
        if flag == 0:
            v = xor.next()
            out[k] = np.uint64(v).view(np.float64) if v is not None \
                else np.nan
            continue
        beta_star = r.get(4)
        vp_bits = xor.next()
        vp = float(np.uint64(vp_bits).view(np.float64))
        sp = math.floor(math.log10(abs(vp)))
        if beta_star == 0:
            # vp is an erased exact power of ten below 1: restore
            # 10^(sp+1) (the Java get10iN(-sp - 1) path)
            v = float(f"1e{sp + 1}")
            out[k] = -v if vp < 0 else v
        else:
            alpha = beta_star - sp - 1
            scale = _pow10(alpha)
            if vp < 0:
                out[k] = math.floor(vp * scale) / scale
            else:
                out[k] = math.ceil(vp * scale) / scale
    return out


def elf_roundtrip(data: np.ndarray) -> bool:
    """Encode + decode + bit-exact comparison (NaN-free input)."""
    payload, _ = elf_encode(data)
    back = elf_decode(payload, len(data))
    return bool(np.array_equal(back.view(np.uint64),
                               np.asarray(data, np.float64).view(np.uint64)))


def elf_bits(data: np.ndarray) -> int:
    """Exact compressed size in bits (encode without materialising)."""
    payload, nbits = elf_encode(data)
    return nbits
