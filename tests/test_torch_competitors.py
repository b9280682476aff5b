"""The port's competitor codecs against the JAX package's, bit for bit.

* Every codec of ``alp_tpu_torch.competitors`` (Gorillas, Chimp, Chimp128,
  Patas, zlib, Elf, PDE, Zstd) gives ``alp_tpu.competitors``'s bit count on
  generated float64 and float32 columns, specials included, and the same
  round-trip verdicts, Elf the same stream and decoded bits, PDE the same
  streams and decoded bits; ``ALL_CODECS`` has the same keys and each
  gives the same count.
* The port's loader of ``native/competitors.cpp`` gives
  ``alp_tpu.native``'s streams, bit counts and decoded bits: the
  XOR-family encode and decode, the chunked encode and decode at 1 and 8
  threads, PDE through ``pde_chunk_stream`` and the native PDE decode.

The Python codecs loop over values, so the columns hold a few thousand.
"""

import numpy as np
import pytest

from alp_tpu import competitors as jcomp
from alp_tpu import native as jnative
from alp_tpu.competitors import elf_codec as jelf
from alp_tpu.competitors import pde_codec as jpde

from alp_tpu_torch import competitors as comp
from alp_tpu_torch import native
from alp_tpu_torch.competitors import elf_codec, pde_codec

XOR_CODECS = ("gorillas", "chimp", "chimp128", "patas")
NATIVE_CODECS = XOR_CODECS + ("pde",)


def _columns() -> dict:
    rng = np.random.default_rng(11)
    n = 3000
    temp = np.round(rng.uniform(-20, 45, n), 1)
    prices = np.round(rng.uniform(0, 500, n), 2)
    noisy = rng.standard_normal(n)
    specials = np.round(rng.uniform(-50, 50, n), 3)
    specials[rng.choice(n, 40, replace=False)] = np.tile(
        [np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324, 1e30, -1e-310], 5)
    runs = np.repeat(np.round(rng.uniform(0, 10, n // 25), 2), 25)
    return {"f64_temp": temp, "f64_prices": prices, "f64_noisy": noisy,
            "f64_specials": specials, "f64_runs": runs,
            "f32_temp": temp.astype(np.float32),
            "f32_noisy": noisy.astype(np.float32),
            "f32_specials": specials.astype(np.float32)}


COLUMNS = _columns()


@pytest.mark.parametrize("name", sorted(COLUMNS))
@pytest.mark.parametrize("codec", XOR_CODECS + ("zlib",))
def test_xor_codec_bits_equal_the_reference(codec, name):
    x = COLUMNS[name]
    assert getattr(comp, f"{codec}_bits")(x) == \
        getattr(jcomp, f"{codec}_bits")(x)


@pytest.mark.parametrize("name", sorted(COLUMNS))
@pytest.mark.parametrize("codec", XOR_CODECS)
def test_xor_codec_round_trips_as_the_reference(codec, name):
    x = COLUMNS[name][:1200]
    got = getattr(comp, f"{codec}_roundtrip")(x)
    assert got == getattr(jcomp, f"{codec}_roundtrip")(x)
    assert got


@pytest.mark.parametrize("name", sorted(n for n in COLUMNS
                                        if n.startswith("f64")))
def test_elf_stream_and_decode_equal_the_reference(name):
    x = COLUMNS[name][:1500]
    payload, nbits = elf_codec.elf_encode(x)
    assert (payload, nbits) == jelf.elf_encode(x)
    assert elf_codec.elf_bits(x) == nbits
    if np.isnan(x).any():
        # NaN is the format's end-of-stream sentinel: the stream stops at
        # the first one, and both decoders fail past it alike
        for dec in (elf_codec.elf_decode, jelf.elf_decode):
            with pytest.raises(TypeError):
                dec(payload, len(x))
        return
    got = elf_codec.elf_decode(payload, len(x))
    want = jelf.elf_decode(payload, len(x))
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    assert elf_codec.elf_roundtrip(x) and jelf.elf_roundtrip(x)


@pytest.mark.parametrize("name", sorted(n for n in COLUMNS
                                        if n.startswith("f64")))
def test_pde_streams_and_decode_equal_the_reference(name):
    x = COLUMNS[name]
    got, want = pde_codec.pde_encode(x), jpde.pde_encode(x)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                     b.view(np.uint8))
    dec = pde_codec.pde_decode(*got)
    assert np.array_equal(dec.view(np.uint64),
                          jpde.pde_decode(*want).view(np.uint64))
    assert np.array_equal(dec.view(np.uint64), x.view(np.uint64))
    assert pde_codec.pde_bits(x) == jpde.pde_bits(x)


def test_all_codecs_equal_the_reference():
    assert list(comp.ALL_CODECS) == list(jcomp.ALL_CODECS)
    for name in ("f64_temp", "f32_temp"):
        x = COLUMNS[name][:1000]
        for codec, fn in comp.ALL_CODECS.items():
            assert fn(x) == jcomp.ALL_CODECS[codec](x), (codec, name)
    assert comp.ALL_CODECS["elf"](COLUMNS["f32_temp"]) is None


def test_zstd_equals_the_reference():
    assert comp.HAVE_ZSTD == jcomp.HAVE_ZSTD
    assert comp.zstd_version() == jcomp.zstd_version()
    for x in COLUMNS.values():
        assert comp.zstd_bits(x) == jcomp.zstd_bits(x)


@pytest.mark.parametrize("name", sorted(n for n in COLUMNS
                                        if n.startswith("f64")))
@pytest.mark.parametrize("codec", XOR_CODECS)
def test_native_streams_equal_the_reference(codec, name):
    x = COLUMNS[name]
    stream, nbits = native.competitor_encode(codec, x)
    want, want_bits = jnative.competitor_encode(codec, x)
    assert nbits == want_bits and np.array_equal(stream, want)
    got = native.competitor_decode(codec, stream, len(x))
    assert np.array_equal(got.view(np.uint64), x.view(np.uint64))
    assert np.array_equal(
        got.view(np.uint64),
        jnative.competitor_decode(codec, want, len(x)).view(np.uint64))


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("codec", NATIVE_CODECS)
def test_native_chunked_equal_the_reference(codec, threads):
    x = np.concatenate([COLUMNS["f64_temp"], COLUMNS["f64_specials"],
                        COLUMNS["f64_noisy"], COLUMNS["f64_runs"]])
    chunk = 1000
    flat, off, words, ns = (a.copy() for a in native.competitor_encode_chunked(
        codec, x, chunk, threads))
    jflat, joff, jwords, jns = jnative.competitor_encode_chunked(
        codec, x, chunk, threads)
    assert np.array_equal(off, joff) and np.array_equal(words, jwords)
    assert np.array_equal(ns, jns)
    streams = [flat[off[c]:off[c] + words[c]].copy() for c in range(len(ns))]
    for c, s in enumerate(streams):
        assert np.array_equal(s, jflat[joff[c]:joff[c] + jwords[c]])
    out = np.zeros(len(x), np.uint64)
    native.competitor_decode_chunked(codec, streams, ns, out, threads)
    jout = np.zeros(len(x), np.uint64)
    jnative.competitor_decode_chunked(codec, streams, ns, jout, threads)
    assert np.array_equal(out, jout)
    if codec == "pde":
        for c, s in enumerate(streams):
            n, at = int(ns[c]), c * chunk
            exp = s[(n + 1) // 2:].view(np.uint8)[:n]
            sel = exp == native.PDE_EXCEPTION
            out[at:at + n][sel] = x.view(np.uint64)[at:at + n][sel]
    assert np.array_equal(out, x.view(np.uint64))


@pytest.mark.parametrize("threads", [1, 8])
def test_native_pde_through_chunk_streams(threads):
    x = np.concatenate([COLUMNS["f64_temp"], COLUMNS["f64_specials"]])
    chunk = 700
    streams, patches, ns = [], [], []
    for at in range(0, len(x), chunk):
        sig, exp, pat = pde_codec.pde_encode(x[at:at + chunk])
        s = native.pde_chunk_stream(sig, exp)
        assert np.array_equal(s, jnative.pde_chunk_stream(sig, exp))
        streams.append(s)
        patches.append((at, exp, pat))
        ns.append(len(sig))
        got = native.pde_decode(sig, exp, pat)
        assert np.array_equal(got.view(np.uint64),
                              jnative.pde_decode(sig, exp, pat).view(
                                  np.uint64))
        assert np.array_equal(got.view(np.uint64),
                              x[at:at + chunk].view(np.uint64))
    out = np.zeros(len(x), np.uint64)
    native.competitor_decode_chunked("pde", streams, np.array(ns), out,
                                     threads)
    vals = out.view(np.float64)
    for at, exp, pat in patches:
        vals[at:at + len(exp)][exp == native.PDE_EXCEPTION] = pat
    assert np.array_equal(out, x.view(np.uint64))


def test_native_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):
        native.competitor_encode("elf", COLUMNS["f64_temp"])
    with pytest.raises(ValueError):
        native.competitor_encode("pde", COLUMNS["f64_temp"])
    with pytest.raises(TypeError):
        native.competitor_encode("chimp", COLUMNS["f32_temp"])
    stream, _ = native.competitor_encode("chimp", COLUMNS["f64_temp"])
    with pytest.raises(ValueError):
        native.competitor_decode("chimp", stream, 3000,
                                 out=np.zeros(10, np.uint64))
