"""Benchmark reporters: compression-ratio and speed CSVs and their metadata.

Counterpart of ``alp_tpu/reports.py``, with the same CSV bodies:

* ratio CSV, header ``idx,column,data_type,size,rowgroups_count,
  vectors_count,decompression_speed(GB_per_s),compression_speed(GB_per_s),``
  (reference benchmarks/benchmark.cpp:32-36): each dataset column
  compressed on the host, decoded (on the card unless the caller passes
  the CPU) and checked bit for bit, its bits per value from
  ``CompressedColumn.bits_per_value``;
* speed CSV ``benchmark_number,name,iterations,throughput,unit``, or rows
  under a caller's header (reference fls_bench reporter,
  benchmarks/fls_bench/fls_bench.hpp:1826-2112).

Each CSV gets a ``.metadata`` sidecar: the time, the device (the card's
name and power limit from ``nvidia-smi``, or ``cpu``), the host and the
units of the speeds.
"""

from __future__ import annotations

import csv
import datetime
import platform

import numpy as np
import torch

from .container import compress, decompress
from .kernels.decode import resolve_device
from .utils import io as uio

RATIO_HEADER = ("idx,column,data_type,size,rowgroups_count,vectors_count,"
                "decompression_speed(GB_per_s),compression_speed(GB_per_s),")


def ratio_report(columns, out_path, dtype=np.float64,
                 speeds: dict | None = None, device=None) -> list:
    """Compress every dataset column that has data, decode it on
    ``device`` (``None`` means ``"cuda"``) and check its bits; write the
    ratio CSV.  ``speeds``: column name -> (decompress, compress) GB/s.
    Returns the rows."""
    dev = resolve_device(device)
    ut = np.uint64 if np.dtype(dtype) == np.float64 else np.uint32
    rows = []
    for i, col in enumerate(columns, 1):
        try:
            data = uio.read_column(col, prefer_binary=True)
        except FileNotFoundError:
            continue
        data = data.astype(dtype) if data.dtype != np.dtype(dtype) else data
        cc = compress(data)
        out = decompress(cc, dev).cpu().numpy()
        if not (out.view(ut) == data.view(ut)).all():
            raise AssertionError(f"{col.name}: round trip differs")
        dec_s, enc_s = (speeds or {}).get(col.name, (0.0, 0.0))
        rows.append((i, col.name, np.dtype(dtype).name, cc.bits_per_value(),
                     cc.n_rowgroups, cc.n_vectors, dec_s, enc_s))
    with open(out_path, "w") as f:
        f.write(RATIO_HEADER + "\n")
        for r in rows:
            f.write(f"{r[0]},{r[1]},{r[2]},{r[3]:.2f},{r[4]},{r[5]},"
                    f"{r[6]:.2f},{r[7]:.2f},\n")
    _write_metadata(out_path + ".metadata", dev)
    return rows


def speed_report(results, out_path, header=None, device=None) -> None:
    """results: [(name, iterations, value, unit)] -> an fls_bench-style
    CSV; with ``header`` (a tuple of column names) the rows are written
    as they are (the end-to-end query table).  ``device``: where the
    speeds were measured (``None`` means ``"cuda"``)."""
    dev = resolve_device(device)
    with open(out_path, "w") as f:
        if header is not None:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(header)
            for row in results:
                w.writerow([str(x) for x in row])
        else:
            f.write("benchmark_number,name,iterations,throughput,unit\n")
            for i, (name, iters, value, unit) in enumerate(results, 1):
                f.write(f"{i},{name},{iters},{value:.3f},{unit}\n")
    _write_metadata(out_path + ".metadata", dev)


def _write_metadata(path, device: torch.device) -> None:
    """The sidecar: the time, the device, the host and the units."""
    if device.type == "cuda":
        from .bench import card_line
        dev_str = f"cuda:{card_line()}"
    else:
        dev_str = device.type
    with open(path, "w") as f:
        f.write(datetime.datetime.now(datetime.timezone.utc).isoformat()
                + "\n")
        f.write(f"Device: {dev_str}\n")
        f.write(f"Host: {platform.platform()} {platform.machine()}\n")
        f.write("Units: speeds in GB/s of decoded values (CUDA events for "
                "loop steps, host clock for walls)\n")
