"""Plan snapshots: a built decode plan kept as bytes and restored on a device.

Counterpart of ``alp_tpu/plan_store.py`` (``snapshot``, ``restore``,
``save_plan``, ``load_plan``) for the port's ``DecodePlan``
(``kernels/decode.py``).  ``build_plan`` does host work a column: it
concatenates ragged per-vector payloads, buckets the vectors and uploads
every bucket from pageable memory.  A kept plan amortises that, but a fresh
process pays it before its first query; a snapshot lets it skip the build.

* :func:`snapshot` writes one blob: a fixed header, a JSON manifest and one
  payload holding every tensor of the plan, each at an offset that is a
  multiple of 256 bytes: every bucket's ``rows`` and kernel arguments, the
  ALP exceptions (``exc_index`` / ``exc_bits``), the ALP_RD exceptions
  (``rd_exc_index`` / ``rd_exc_left`` / ``rd_exc_rbw``) and, when the
  plan has them, its kept ``vector_sums``; a kept ``key_extent`` (two
  integers) goes in the manifest.  The payload is gathered on the plan's
  device and copied to the host once, and is zstd-compressed (level 3,
  ``competitors.zstd_codec``) when it holds 64 KiB or more and the
  compressed form is smaller.  The per-vector CSRs ``exc_ptr`` and
  ``rd_exc_ptr`` are not stored: they are rebuilt at first use.
* :func:`restore` copies the payload to the device once, from pinned host
  memory, and makes every tensor of the plan a view of it by offset and
  dtype.  The offsets keep each view's data 256-byte aligned, as the
  kernels' wide loads need (K5/K6 refuse rows that do not start on 16
  bytes).

The JAX package's snapshot holds lane-expanded TPU planes, softfloat
constants and a jitted restore program; the port's plan has none of these,
so the two formats do not interchange: the port's blobs start with
``ALPS`` (the JAX package's with ``ALPP``), and :func:`restore` refuses
anything else with ``ValueError``, as it does a truncated blob or a
corrupt zstd payload.  The blob is an acceleration artifact: the ``ALPT``
container stays the canonical bytes, and a snapshot can always be made
again from it.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from .competitors import zstd_codec
from .kernels.decode import Bucket, DecodePlan, resolve_device

_MAGIC = b"ALPS"
_VERSION = 1
# magic, version, payload codec, 0, manifest bytes, payload bytes, stored
# payload bytes (after compression)
_HEAD = "<4sHBBIQQ"
_HEAD_SIZE = struct.calcsize(_HEAD)
_ALIGN = 256
_CODEC_RAW = 0
_CODEC_ZSTD = 1
_ZSTD_MIN = 1 << 16
# the dtypes of a plan's tensors
_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.int16, torch.int32, torch.int64, torch.float32, torch.float64)}
_EXCEPTIONS = ("exc_index", "exc_bits", "rd_exc_index", "rd_exc_left",
               "rd_exc_rbw")


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class _Payload:
    """The tensors of a plan laid out at aligned offsets, in the order
    they are added; ``spec`` gives the manifest entry of each."""

    def __init__(self):
        self.tensors = []
        self.size = 0

    def spec(self, t: torch.Tensor) -> dict:
        name = str(t.dtype).removeprefix("torch.")
        if name not in _DTYPES:
            raise TypeError(f"plan snapshot: unsupported dtype {t.dtype}")
        entry = {"off": self.size, "dtype": name, "shape": list(t.shape)}
        self.tensors.append((self.size, t))
        self.size = _aligned(self.size + t.numel() * t.element_size())
        return entry

    def gather(self, device) -> torch.Tensor:
        """Every tensor's bytes in one uint8 buffer on ``device`` (the
        gaps zero, so a plan always gives the same blob)."""
        buf = torch.zeros(self.size, dtype=torch.uint8, device=device)
        for off, t in self.tensors:
            n = t.numel() * t.element_size()
            if n:
                buf[off:off + n].view(t.dtype).copy_(t.reshape(-1))
        return buf


def snapshot(plan: DecodePlan, *, compress: bool = True) -> bytes:
    """Serialise a built decode plan into one self-contained blob."""
    pay = _Payload()
    manifest = {
        "dtype": np.dtype(plan.dtype).name,
        "n_values": int(plan.n_values),
        "n_vectors": int(plan.n_vectors),
        "buckets": [{"scheme": int(b.scheme), "bw": int(b.bw),
                     "lbw": int(b.lbw), "rows": pay.spec(b.rows),
                     "args": [pay.spec(a) for a in b.args]}
                    for b in plan.buckets],
        **{name: pay.spec(getattr(plan, name)) for name in _EXCEPTIONS},
        "key_extent": (None if plan.key_extent is None
                       else [int(k) for k in plan.key_extent]),
        "vector_sums": (None if plan.vector_sums is None
                        else [pay.spec(t) for t in plan.vector_sums]),
    }
    raw = pay.gather(plan.device).cpu().numpy().tobytes()
    stored, codec = raw, _CODEC_RAW
    if compress and zstd_codec.HAVE_ZSTD and len(raw) >= _ZSTD_MIN:
        z = zstd_codec._compress_chunk(zstd_codec._load(), raw)
        if len(z) < len(raw):
            stored, codec = z, _CODEC_ZSTD
    mjson = json.dumps(manifest).encode()
    head = struct.pack(_HEAD, _MAGIC, _VERSION, codec, 0, len(mjson),
                       len(raw), len(stored))
    return head + mjson + stored


def snapshot_codec(blob: bytes) -> str:
    """``"zstd"`` or ``"raw"``: how a snapshot stores its payload."""
    return "zstd" if _header(blob)[2] == _CODEC_ZSTD else "raw"


def _header(blob: bytes) -> tuple:
    if len(blob) < _HEAD_SIZE:
        raise ValueError("plan snapshot: truncated header")
    magic, ver, codec, _, mlen, n_raw, n_stored = struct.unpack_from(
        _HEAD, blob, 0)
    if magic != _MAGIC or ver != _VERSION:
        raise ValueError(f"not an alp_tpu_torch plan snapshot ("
                         f"{_MAGIC.decode()} v{_VERSION})")
    if codec not in (_CODEC_RAW, _CODEC_ZSTD) or (
            codec == _CODEC_RAW and n_stored != n_raw):
        raise ValueError("plan snapshot: bad payload codec")
    if len(blob) != _HEAD_SIZE + mlen + n_stored:
        raise ValueError(f"plan snapshot: {len(blob)} bytes, the header "
                         f"says {_HEAD_SIZE + mlen + n_stored}")
    return magic, ver, codec, mlen, n_raw, n_stored


def _fill(host: torch.Tensor, blob: bytes, codec: int, start: int) -> None:
    """Write the raw payload, stored in ``blob`` from ``start``, into the
    uint8 tensor ``host``: copied, or decompressed straight into it."""
    if codec == _CODEC_RAW:
        host.numpy()[:] = np.frombuffer(blob, np.uint8, host.numel(), start)
        return
    if not zstd_codec.HAVE_ZSTD:
        raise RuntimeError("plan snapshot: a zstd payload needs libzstd")
    if not zstd_codec.decompress_into(blob, start, host.data_ptr(),
                                      host.numel()):
        raise ValueError("plan snapshot: corrupt zstd payload")


def restore(blob: bytes, device=None) -> DecodePlan:
    """Rebuild a decode plan from a snapshot on ``device`` (``None`` means
    ``"cuda"`` and raises when no card is present; ``"cpu"`` for the plain
    versions): one host->device copy of the payload, every tensor a view
    of it.  Raises ``ValueError`` for a blob that is not a whole snapshot
    of this format."""
    dev = resolve_device(device)
    blob = bytes(blob)
    _, _, codec, mlen, n_raw, _ = _header(blob)
    try:
        manifest = json.loads(blob[_HEAD_SIZE:_HEAD_SIZE + mlen])
    except ValueError as e:          # also UnicodeDecodeError
        raise ValueError(f"plan snapshot: bad manifest ({e})") from e
    host = torch.empty(n_raw, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    _fill(host, blob, codec, _HEAD_SIZE + mlen)
    buf = host.to(dev, non_blocking=True)

    def view(spec) -> torch.Tensor:
        off, shape = spec["off"], [int(s) for s in spec["shape"]]
        dt = _DTYPES[spec["dtype"]]
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if off % _ALIGN or off < 0 or min(shape, default=0) < 0 \
                or off + n > n_raw:
            raise ValueError(f"plan snapshot: bad tensor entry {spec}")
        return buf[off:off + n].view(dt).view(shape)

    try:
        buckets = [Bucket(int(b["scheme"]), int(b["bw"]), int(b["lbw"]),
                          view(b["rows"]), tuple(view(a) for a in b["args"]))
                   for b in manifest["buckets"]]
        extent, sums = manifest["key_extent"], manifest["vector_sums"]
        return DecodePlan(
            np.dtype(manifest["dtype"]), int(manifest["n_values"]),
            int(manifest["n_vectors"]), dev, buckets,
            *(view(manifest[name]) for name in _EXCEPTIONS),
            key_extent=None if extent is None else tuple(map(int, extent)),
            vector_sums=None if sums is None else tuple(map(view, sums)))
    except (KeyError, TypeError) as e:
        raise ValueError(f"plan snapshot: bad manifest ({e!r})") from e


def save_plan(col, path, device=None) -> int:
    """Snapshot ``col``'s decode plan on ``device`` (``col.plan(device)``,
    built if need be) to ``path``; returns the blob's byte size."""
    blob = snapshot(col.plan(device))
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def load_plan(path, device=None) -> DecodePlan:
    """:func:`restore` of the snapshot in the file ``path``."""
    with open(path, "rb") as f:
        return restore(f.read(), device)
