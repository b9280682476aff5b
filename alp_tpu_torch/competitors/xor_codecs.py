"""XOR-family codecs (Gorillas / Chimp / Chimp128 / Patas) + zlib.

Counterpart of ``alp_tpu/competitors/xor_codecs.py``, host numpy as
there: the same bit counts and the same decoded bits.

Bit-cost models transcribed from the reference implementations:
* Gorillas: publication/source_code/include/gorillas/gorillas.hpp:55-121
  (2-bit flags, 5-bit leading, 6-bit significant-length, window reuse)
* Chimp: include/chimp/chimp.hpp:90-140 (2-bit flags, 3-bit rounded
  leading representation, 6-bit significant length, trailing>6 branch)
* Chimp128: include/chimp/chimp128.hpp:102-165 (128-entry ring buffer
  keyed on the low 14 bits, 16-bit packed metadata on the trailing
  branch, 7-bit index on the identical branch)
* Patas: include/patas/patas.hpp:55-110 (byte-aligned significant
  bytes + 16-bit packed metadata per value)

The leading-zero rounding table is LEADING_ROUND
(chimp_utils.hpp:119-128).  Encoders return exact total bit counts;
``gorillas_roundtrip`` additionally validates a real decode.
"""

from __future__ import annotations

import zlib

import numpy as np

_LEADING_ROUND = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 8, 8, 8, 8, 12, 12, 12, 12,
     16, 16, 18, 18, 20, 20, 22, 22] + [24] * 41, np.uint8)


def _lz_tz(xor: np.ndarray, width: int):
    """Vectorised leading/trailing zero counts (width 32 or 64)."""
    ut = xor.dtype.type
    lz = np.zeros(xor.shape, np.int64)
    x = xor.copy()
    for s in (32, 16, 8, 4, 2, 1):
        if s < width:
            big = (x >> ut(s)) != 0
            lz += np.where(big, s, 0)
            x = np.where(big, x >> ut(s), x)
    bl = lz + (x != 0)                     # bit length
    lz = width - bl
    lowest = xor & (~xor + ut(1))          # isolate lowest set bit
    tz = np.zeros(xor.shape, np.int64)
    x = lowest.copy()
    for s in (32, 16, 8, 4, 2, 1):
        if s < width:
            big = (x >> ut(s)) != 0
            tz += np.where(big, s, 0)
            x = np.where(big, x >> ut(s), x)
    tz = np.where(xor == 0, width, tz)
    lz = np.where(xor == 0, width, lz)
    return lz, tz


def _bits_view(data: np.ndarray):
    if data.dtype == np.float64:
        return data.view(np.uint64), 64
    return data.view(np.uint32), 32


def gorillas_bits(data: np.ndarray) -> int:
    bits, W = _bits_view(np.ascontiguousarray(data))
    xor = np.concatenate([bits[:1], bits[1:] ^ bits[:-1]])
    lz_a, tz_a = _lz_tz(xor, W)
    lz_a = np.minimum(lz_a, 31)
    total = W  # first value
    pl, pt = 0, 0
    for i in range(1, len(bits)):
        if xor[i] == 0:
            total += 2
            continue
        lz, tz = int(lz_a[i]), int(tz_a[i])
        if lz >= pl and tz >= pt:
            total += 2 + (W - pl - pt)
        else:
            total += 2 + 5 + 6 + (W - lz - tz)
            pl, pt = lz, tz
    return total


def gorillas_roundtrip(data: np.ndarray) -> bool:
    """Real encode+decode of the Gorillas scheme (bitstream level)."""
    bits, W = _bits_view(np.ascontiguousarray(data))
    ut = bits.dtype.type
    stream = []  # (value, nbits)

    def put(v, n):
        stream.append((int(v) & ((1 << n) - 1), n))

    put(bits[0], W)
    pl, pt = 0, 0
    prev = int(bits[0])
    for i in range(1, len(bits)):
        x = int(bits[i]) ^ prev
        if x == 0:
            put(0b00, 2)
        else:
            lz = min((W - x.bit_length()), 31)
            tz = (x & -x).bit_length() - 1
            if lz >= pl and tz >= pt:
                put(0b10, 2)
                put(x >> pt, W - pl - pt)
            else:
                put(0b11, 2)
                put(lz, 5)
                put(W - lz - tz - 1, 6)
                put(x >> tz, W - lz - tz)
                pl, pt = lz, tz
        prev = int(bits[i])

    # decode
    flat = []
    for v, n in stream:
        for b in range(n - 1, -1, -1):
            flat.append((v >> b) & 1)
    pos = 0

    def get(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            v = (v << 1) | flat[pos]
            pos += 1
        return v

    out = [get(W)]
    pl, pt = 0, 0
    while len(out) < len(bits):
        f = get(2)                 # flags are fixed 2-bit (flag buffer)
        if f == 0b00:
            out.append(out[-1])
            continue
        if f == 0b10:
            x = get(W - pl - pt) << pt
        else:
            pl = get(5)
            sig = get(6) + 1
            x = get(sig) << (W - pl - sig)
            x = x >> (W - pl - sig) << (W - pl - sig)  # already aligned
            pt = W - pl - sig
        out.append(out[-1] ^ x)
    got = np.array(out, dtype=ut)
    return bool((got == bits).all())


def chimp_roundtrip(data: np.ndarray) -> bool:
    """Real encode+decode of the Chimp scheme at the bitstream level
    (chimp.hpp:90-140 semantics: 2-bit flags, rounded-leading 3-bit
    representation, trailing>6 branch with 6-bit significant length)."""
    bits, W = _bits_view(np.ascontiguousarray(data))
    ut = bits.dtype.type
    lead_repr = {0: 0, 8: 1, 12: 2, 16: 3, 18: 4, 20: 5, 22: 6, 24: 7}
    repr_lead = {v: k for k, v in lead_repr.items()}
    stream = []

    def put(v, n):
        if n:
            stream.append((int(v) & ((1 << n) - 1), n))

    put(bits[0], W)
    prev = int(bits[0])
    prev_lead = 255
    for i in range(1, len(bits)):
        x = int(bits[i]) ^ prev
        if x == 0:
            put(0b00, 2)
            prev_lead = 255
        else:
            lz = int(_LEADING_ROUND[min(W - x.bit_length(), 64)])
            tz = (x & -x).bit_length() - 1
            if tz > 6:
                sig = W - lz - tz
                put(0b01, 2)
                put(lead_repr[lz], 3)
                put(sig, 6)
                put(x >> tz, sig)
                prev_lead = 255
            elif lz == prev_lead:
                put(0b10, 2)
                put(x, W - lz)
            else:
                put(0b11, 2)
                put(lead_repr[lz], 3)
                put(x, W - lz)
                prev_lead = lz
        prev = int(bits[i])

    flat = []
    for v, n in stream:
        for b in range(n - 1, -1, -1):
            flat.append((v >> b) & 1)
    pos = 0

    def get(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            v = (v << 1) | flat[pos]
            pos += 1
        return v

    out = [get(W)]
    prev_lead = 255
    while len(out) < len(bits):
        f = get(2)
        if f == 0b00:
            out.append(out[-1])
            prev_lead = 255
            continue
        if f == 0b01:
            lz = repr_lead[get(3)]
            sig = get(6)
            tz = W - lz - sig
            x = get(sig) << tz
            prev_lead = 255
        elif f == 0b10:
            x = get(W - prev_lead)
        else:
            lz = repr_lead[get(3)]
            x = get(W - lz)
            prev_lead = lz
        out.append(out[-1] ^ x)
    return bool((np.array(out, dtype=ut) == bits).all())


def chimp_bits(data: np.ndarray) -> int:
    bits, W = _bits_view(np.ascontiguousarray(data))
    xor = np.concatenate([bits[:1], bits[1:] ^ bits[:-1]])
    lz_a, tz_a = _lz_tz(xor, W)
    total = W
    prev_lead = 255
    for i in range(1, len(bits)):
        if xor[i] == 0:
            total += 2
            prev_lead = 255
            continue
        lz = int(_LEADING_ROUND[min(int(lz_a[i]), 64)])
        tz = int(tz_a[i])
        if tz > 6:
            total += 2 + 3 + 6 + (W - lz - tz)
            prev_lead = 255
        elif lz == prev_lead:
            total += 2 + (W - lz)
        else:
            total += 2 + 3 + (W - lz)
            prev_lead = lz
    return total


def chimp128_roundtrip(data: np.ndarray) -> bool:
    """Real encode+decode of the Chimp128 scheme (chimp128.hpp:102-165):
    ring-buffer reference selection keyed on the low 14 bits, 2-bit
    flags, 7-bit index on the identical branch, 16-bit packed metadata
    (index:7, leading-repr:3, significant:6) on the trailing branch."""
    bits, W = _bits_view(np.ascontiguousarray(data))
    ut = bits.dtype.type
    lead_repr = {0: 0, 8: 1, 12: 2, 16: 3, 18: 4, 20: 5, 22: 6, 24: 7}
    repr_lead = {v: k for k, v in lead_repr.items()}
    key_bits = 6 + 7 + 1
    key_mask = (1 << key_bits) - 1
    threshold = 6 + 7
    stream = []

    def put(v, n):
        if n:
            stream.append((int(v) & ((1 << n) - 1), n))

    ring = [0] * 128
    indices = {}
    v0 = int(bits[0])
    put(v0, W)
    ring[0] = v0
    indices[v0 & key_mask] = 0
    size = 0
    prev_lead = 255
    for i in range(1, len(bits)):
        v = int(bits[i])
        key = v & key_mask
        ref_idx = indices.get(key, 0)
        trailing_exceeds = False
        prev_index = size % 128
        tz = 0
        if size - ref_idx < 128:
            cur = 0 if ref_idx > size else ref_idx
            tempxor = v ^ ring[cur % 128]
            tz = (tempxor & -tempxor).bit_length() - 1 if tempxor else W
            if tz > threshold:
                trailing_exceeds = True
                prev_index = cur % 128
                xor = tempxor
            else:
                xor = v ^ ring[size % 128]
        else:
            xor = v ^ ring[size % 128]
        if xor == 0:
            put(0b00, 2)
            put(prev_index, 7)
            prev_lead = 255
        else:
            lz = int(_LEADING_ROUND[W - xor.bit_length()])
            if trailing_exceeds:
                sig = W - lz - tz
                put(0b01, 2)
                put(prev_index, 7)
                put(lead_repr[lz], 3)
                put(sig, 6)
                put(xor >> tz, sig)
                prev_lead = 255
            elif lz == prev_lead:
                put(0b10, 2)
                put(xor, W - lz)
            else:
                put(0b11, 2)
                put(lead_repr[lz], 3)
                put(xor, W - lz)
                prev_lead = lz
        size += 1
        ring[size % 128] = v
        indices[key] = size

    flat = []
    for v, n in stream:
        for b in range(n - 1, -1, -1):
            flat.append((v >> b) & 1)
    pos = 0

    def get(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            v = (v << 1) | flat[pos]
            pos += 1
        return v

    ring2 = [0] * 128
    out = [get(W)]
    ring2[0] = out[0]
    size = 0
    prev_lead = 255
    while len(out) < len(bits):
        f = get(2)
        if f == 0b00:
            idx = get(7)
            v = ring2[idx]
            prev_lead = 255
        elif f == 0b01:
            idx = get(7)
            lz = repr_lead[get(3)]
            sig = get(6)
            tz = W - lz - sig
            x = get(sig) << tz
            v = ring2[idx] ^ x
            prev_lead = 255
        elif f == 0b10:
            x = get(W - prev_lead)
            v = out[-1] ^ x
        else:
            lz = repr_lead[get(3)]
            x = get(W - lz)
            v = out[-1] ^ x
            prev_lead = lz
        out.append(v)
        size += 1
        ring2[size % 128] = v
    return bool((np.array(out, dtype=ut) == bits).all())


def chimp128_bits(data: np.ndarray) -> int:
    bits, W = _bits_view(np.ascontiguousarray(data))
    key_bits = 6 + 7 + 1  # SignificantBits + 7 + 1 (ring_buffer.hpp:19)
    key_mask = (1 << key_bits) - 1
    threshold = 6 + 7      # TRAILING_ZERO_THRESHOLD
    ring = [0] * 128
    indices = {}
    total = W
    ring[0] = int(bits[0])
    indices[int(bits[0]) & key_mask] = 0
    size = 0
    prev_lead = 255
    for i in range(1, len(bits)):
        v = int(bits[i])
        key = v & key_mask
        ref_idx = indices.get(key, 0)
        trailing_exceeds = False
        if size - ref_idx < 128:
            cur = 0 if ref_idx > size else ref_idx
            tempxor = v ^ ring[cur % 128]
            tz = (tempxor & -tempxor).bit_length() - 1 if tempxor else W
            if tz > threshold:
                trailing_exceeds = True
                xor = tempxor
            else:
                xor = v ^ ring[size % 128]
        else:
            xor = v ^ ring[size % 128]
            tz = 0
        if xor == 0:
            total += 2 + 7
            prev_lead = 255
        else:
            lz = int(_LEADING_ROUND[W - xor.bit_length()])
            if trailing_exceeds:
                total += 2 + 16 + (W - lz - tz)
                prev_lead = 255
            elif lz == prev_lead:
                total += 2 + (W - lz)
            else:
                total += 2 + 3 + (W - lz)
                prev_lead = lz
        size += 1
        ring[size % 128] = v
        indices[key] = size
    return total


def patas_roundtrip(data: np.ndarray) -> bool:
    """Real encode+decode of the Patas scheme (patas.hpp:55-110):
    byte-aligned XOR payload + 16-bit packed metadata
    (index_diff:7, byte_count:3, trailing_zeros:6) per value."""
    bits, W = _bits_view(np.ascontiguousarray(data))
    ut = bits.dtype.type
    key_bits = 6 + 7 + 1
    key_mask = (1 << key_bits) - 1
    ring = [0] * 128
    indices = {}
    payload = []          # (value, nbits byte-aligned)
    meta = []             # (index_diff, byte_count, trailing_zero)
    payload.append((int(bits[0]), W))
    meta.append((0, W // 8, 0))
    ring[0] = int(bits[0])
    indices[int(bits[0]) & key_mask] = 0
    size = 0
    for i in range(1, len(bits)):
        v = int(bits[i])
        key = v & key_mask
        ref_idx = indices.get(key, 0)
        if ref_idx > size or (size + 1 - ref_idx) >= 128:
            ref_idx = size
        ref = ring[ref_idx % 128]
        xor = v ^ ref
        is_equal = xor == 0
        tz = ((xor & -xor).bit_length() - 1) if xor else W
        lz = (W - xor.bit_length()) if xor else W
        sig_bits = 0 if is_equal else (W - tz - lz)
        sig_bytes = (sig_bits >> 3) + (1 if sig_bits & 7 else 0)
        payload.append((xor >> (tz - is_equal), sig_bytes * 8))
        meta.append((size + 1 - ref_idx, sig_bytes, tz - is_equal))
        size += 1
        ring[size % 128] = v
        indices[key] = size

    # decode
    out = []
    ring2 = [0] * 128
    for i, ((val, nbits), (idiff, nbytes, tz)) in enumerate(
            zip(payload, meta)):
        if i == 0:
            v = val
        else:
            ref = ring2[(i - idiff) % 128]
            v = ref ^ (val << tz)
        ring2[i % 128] = v
        out.append(v)
    return bool((np.array(out, dtype=ut) == bits).all())


def patas_bits(data: np.ndarray) -> int:
    bits, W = _bits_view(np.ascontiguousarray(data))
    key_bits = 6 + 7 + 1
    key_mask = (1 << key_bits) - 1
    ring = [0] * 128
    indices = {}
    total = W + 16
    ring[0] = int(bits[0])
    indices[int(bits[0]) & key_mask] = 0
    size = 0
    for i in range(1, len(bits)):
        v = int(bits[i])
        key = v & key_mask
        ref_idx = indices.get(key, 0)
        if ref_idx > size or (size + 1 - ref_idx) >= 128:
            ref_idx = size
        ref = ring[ref_idx % 128]
        xor = v ^ ref
        sig_bits = 0 if xor == 0 else xor.bit_length() - (
            (xor & -xor).bit_length() - 1)
        sig_bytes = (sig_bits >> 3) + (1 if sig_bits & 7 else 0)
        total += 16 + 8 * sig_bytes
        size += 1
        ring[size % 128] = v
        indices[key] = size
    return total


def zlib_bits(data: np.ndarray) -> int:
    """DEFLATE at max level — general-purpose-codec stand-in for Zstd
    (reference fetches zstd v1.5.5; not available in this image)."""
    return len(zlib.compress(np.ascontiguousarray(data).tobytes(), 9)) * 8
