"""scan_gb_per_s: decoded (logical) bytes of the column that each
answered request covered, summed over the window, over the window's
seconds, in GB/s (host clock).  A request counts its column once, at
its values' width (8 bytes a float64, 4 a float32)."""

from harness import window


def read(run):
    rate = window.rate(run.window,
                       lambda r: run.infos[r.column].value_bytes
                       * run.infos[r.column].n_values)
    return rate / 1e9
