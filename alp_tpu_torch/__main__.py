"""CLI: compress and inspect a column of your own (bench_your_dataset analog).

    python -m alp_tpu_torch <file.bin|file.csv> [--f32] [--no-verify]
                            [--device cpu]

Counterpart of ``python -m alp_tpu`` (the reference's
benchmarks/bench_your_dataset.cpp flow): load a raw little-endian binary or
one-value-per-line CSV column, compress it on the host with adaptive
scheme selection, print the cost-model ratio and the serialized size,
decode it on the card (the wall of ``decompress``: plan build, copies and
kernels) and on the host (``decompress_host``, the native engine, as
``python -m alp_tpu`` does), and check both round trips bit for bit.
``--device cpu`` decodes with the kernels' plain versions instead of the
card; without a card and without it the CLI exits nonzero.
"""

import argparse
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m alp_tpu_torch",
                                 description=__doc__)
    ap.add_argument("path", help="raw .bin (little-endian) or .csv column")
    ap.add_argument("--f32", action="store_true",
                    help="treat data as float32 (default float64)")
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where to decode: a CUDA device (the default, "
                         "'cuda') or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)

    from . import constants as C
    from .container import compress, decompress, decompress_host
    from .kernels.decode import resolve_device
    from .utils import io as uio

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"alp_tpu_torch: {e} (on the command line: --device cpu)",
              file=sys.stderr)
        return 1
    dtype = np.float32 if args.f32 else np.float64
    if args.path.endswith(".csv"):
        data = uio.read_csv(args.path, dtype)
    else:
        data = np.fromfile(args.path, dtype)
    print(f"{len(data):,} values ({data.nbytes / 1e6:.1f} MB)")

    t0 = time.perf_counter()
    cc = compress(data)
    enc_dt = time.perf_counter() - t0
    schemes = {C.SCHEME_ALP: "ALP", C.SCHEME_ALP_RD: "ALP_RD"}
    used = sorted({schemes[s] for s in cc.rg_scheme})
    print(f"scheme(s): {', '.join(used)}   rowgroups: {cc.n_rowgroups}   "
          f"vectors: {cc.n_vectors}")
    print(f"bits/value (cost model): {cc.bits_per_value():.2f}  "
          f"(raw: {np.dtype(dtype).itemsize * 8})")
    blob = cc.to_bytes()
    print(f"serialized: {len(blob):,} bytes "
          f"({len(blob) / data.nbytes:.3f}x raw)")
    print(f"compress:   {data.nbytes / enc_dt / 1e9:.3f} GB/s (host)")

    t0 = time.perf_counter()
    out = decompress(cc, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dec_dt = time.perf_counter() - t0
    print(f"decompress: {data.nbytes / dec_dt / 1e9:.3f} GB/s ({dev} wall: "
          f"plan build, copies, kernels)")
    t0 = time.perf_counter()
    host = decompress_host(cc)
    host_dt = time.perf_counter() - t0
    print(f"decompress: {data.nbytes / host_dt / 1e9:.3f} GB/s (host)")

    if not args.no_verify:
        ut = np.uint64 if dtype == np.float64 else np.uint32
        for where, got in ((str(dev), out.cpu().numpy()), ("host", host)):
            if not (got.view(ut) == data.view(ut)).all():
                print(f"round-trip: MISMATCH ({where})", file=sys.stderr)
                return 1
        print("round-trip: bit-exact OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
