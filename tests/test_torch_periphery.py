"""The port's periphery against the JAX package's, on the CPU.

* ``alp_tpu_torch.utils.datasets``: every registry column equals
  ``alp_tpu.utils.datasets``'s field by field, paths included (under the
  same ``ALP_TPU_DATA_DIR`` / ``ALP_DATASET_DIR_PATH``), and
  ``utils.published``'s tables equal the reference's.
* ``utils.io``: ``read_csv`` (trailing commas, float32 parsed with one
  rounding), ``read_binary``, ``mmap_binary``, ``read_column`` and
  ``read_first_vector`` give the reference's arrays on temporary files.
* ``reports``: ``ratio_report`` (decoding with ``device="cpu"``) and
  ``speed_report`` write the reference reporters' CSV bodies byte for
  byte on temporary dataset columns (the speeds are the caller's, so
  equal here too), and a sidecar naming the CPU.
* ``python -m alp_tpu_torch`` with ``--device cpu`` prints
  ``python -m alp_tpu``'s lines on .bin and .csv columns, float64 and
  float32, apart from the timing lines; it prints the host decode's
  ``decompress: ... GB/s (host)`` line (``decompress_host``) and fails
  when that decode's bits differ; without a card and without ``--device
  cpu`` it exits nonzero, as ``python -m alp_tpu_torch.bench_e2e`` does.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from alp_tpu import __main__ as jcli
from alp_tpu import reports as jreports
from alp_tpu.utils import datasets as jdatasets
from alp_tpu.utils import io as jio
from alp_tpu.utils import published as jpublished

from alp_tpu_torch import __main__ as cli
from alp_tpu_torch import reports
from alp_tpu_torch.utils import datasets, io, published

ROOT = pathlib.Path(__file__).resolve().parent.parent
REGISTRIES = ("ALP_DATASET", "GENERATED_COLUMNS", "EDGE_CASE",
              "FLOAT_EDGE_CASE", "FLOAT_TEST_DATASET", "DOUBLE_TEST_DATASET",
              "ISSUE_DATASET", "HURRICANE_ISABEL", "EVALIMPLSTS",
              "SP_DATASETS")
TABLES = ("TABLE_4", "SUITE_AVG", "GOLDEN_FULL_RATIO", "GOLDEN_ISSUE_RATIO",
          "TABLE_7_SP", "SP_ALP_RUNNER", "HURRICANE_ALP_RUNNER")


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    root = tmp_path / "data"
    (root / "samples").mkdir(parents=True)
    (root / "float").mkdir()
    monkeypatch.setenv("ALP_TPU_DATA_DIR", str(root))
    monkeypatch.delenv("ALP_DATASET_DIR_PATH", raising=False)
    monkeypatch.delenv("HURRICANE_ISABEL_DATASET_DIR_PATH", raising=False)
    return root


def _write_csv(path, values, trailing=False):
    path.write_text("".join(f"{v!r}{',' if trailing else ''}\n"
                            for v in values.tolist()))


@pytest.mark.parametrize("name", REGISTRIES)
def test_registry_equals_the_reference(name, data_dir, tmp_path,
                                       monkeypatch):
    full = tmp_path / "full"
    full.mkdir()
    (full / "neon_air_pressure.bin").write_bytes(b"\0" * 16)
    monkeypatch.setenv("ALP_DATASET_DIR_PATH", str(full))
    mine, want = getattr(datasets, name), getattr(jdatasets, name)
    assert len(mine) == len(want)
    for a, b in zip(mine, want):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert (a.csv_path, a.binary_path) == (b.csv_path, b.binary_path)
    assert datasets.data_dir() == jdatasets.data_dir() == data_dir
    assert datasets.binary_dir() == jdatasets.binary_dir() == full


def test_golden_columns_and_published_tables_equal_the_reference():
    assert ([dataclasses.astuple(c) for c in datasets.all_golden_columns()]
            == [dataclasses.astuple(c)
                for c in jdatasets.all_golden_columns()])
    for name in TABLES:
        assert getattr(published, name) == getattr(jpublished, name), name
    for name in list(published.TABLE_4) + ["no such column"]:
        assert published.published(name) == jpublished.published(name)


def test_readers_equal_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    x = np.round(rng.uniform(-100, 100, 3000), 3)
    x[[5, 17]] = [-0.0, 1e-310]
    plain, commas = tmp_path / "a.csv", tmp_path / "b.csv"
    _write_csv(plain, x)
    _write_csv(commas, x, trailing=True)
    f32 = tmp_path / "c.csv"
    f32.write_text("".join(f"{v:.9g}\n" for v in rng.uniform(0, 1, 2000)))
    binary = tmp_path / "d.bin"
    x.tofile(binary)
    for path in (plain, commas, f32):
        for dtype in (np.float64, np.float32):
            got, want = io.read_csv(path, dtype), jio.read_csv(path, dtype)
            assert got.dtype == want.dtype == dtype
            assert np.array_equal(got.view(f"u{got.itemsize}"),
                                  want.view(f"u{want.itemsize}"))
    for read in ("read_binary", "mmap_binary"):
        got = getattr(io, read)(binary, np.float64)
        want = getattr(jio, read)(binary, np.float64)
        assert np.array_equal(np.asarray(got).view(np.uint64),
                              np.asarray(want).view(np.uint64))


def test_read_column_equals_the_reference(data_dir):
    x = np.round(np.random.default_rng(4).uniform(0, 1100, 2500), 1)
    _write_csv(data_dir / "samples" / "neon_air_pressure.csv", x,
               trailing=True)
    mine, want = datasets.ALP_DATASET[0], jdatasets.ALP_DATASET[0]
    for read in ("read_column", "read_first_vector"):
        got, ref = getattr(io, read)(mine), getattr(jio, read)(want)
        assert np.array_equal(got.view(np.uint64), ref.view(np.uint64))
    with pytest.raises(FileNotFoundError):
        io.read_column(datasets.ALP_DATASET[1])


def _dataset_csvs(data_dir):
    rng = np.random.default_rng(5)
    n = 3 * 1024 + 100
    _write_csv(data_dir / "samples" / "city_temperature_f.csv",
               np.round(rng.uniform(-20, 110, n), 1))
    _write_csv(data_dir / "samples" / "poi_lat.csv", rng.uniform(-90, 90, n))
    _write_csv(data_dir / "samples" / "gov26.csv", np.zeros(n))
    _write_csv(data_dir / "float" / "test_1.csv",
               np.round(rng.uniform(0, 50, n), 2))


def test_report_csvs_equal_the_reference(data_dir, tmp_path):
    _dataset_csvs(data_dir)
    out = tmp_path / "out"
    out.mkdir()
    for cols, jcols, dtype in (
            (datasets.ALP_DATASET, jdatasets.ALP_DATASET, np.float64),
            (datasets.FLOAT_TEST_DATASET, jdatasets.FLOAT_TEST_DATASET,
             np.float32)):
        speeds = {"City-Temp": (12.5, 3.25), "test_1": (1.0, 2.0)}
        mine, want = str(out / "mine.csv"), str(out / "want.csv")
        rows = reports.ratio_report(cols, mine, dtype, speeds, device="cpu")
        jrows = jreports.ratio_report(jcols, want, dtype, speeds)
        assert len(rows) == len(jrows) > 0
        assert open(mine).read() == open(want).read()
        meta = open(mine + ".metadata").read().splitlines()
        assert meta[1] == "Device: cpu"
        assert "TPU" not in meta[3] and "CUDA events" in meta[3]
    results = [("falp_f64_bw16", 30, 1234.5678, "GB/s"),
               ("e2e_sum_query_64MiB", 30, 12.0, "GB/s")]
    header = ("query", "scheme", "parallelism", "gbps", "alp_speedup")
    table = [("SUM exact", "ALP", "1 card", 512.25, ""),
             ("SUM-scan decode", "chimp", "8 thr", 2.5, 204.9)]
    for args in ((results,), (table, header)):
        mine, want = str(out / "s_mine.csv"), str(out / "s_want.csv")
        reports.speed_report(args[0], mine, *args[1:], device="cpu")
        jreports.speed_report(args[0], want, *args[1:])
        assert open(mine).read() == open(want).read()


def _cli_lines(main, argv, capsys) -> list:
    assert main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    return [ln for ln in lines
            if not ln.startswith(("compress:", "decompress:"))]


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("suffix", [".bin", ".csv"])
def test_cli_equals_the_reference(suffix, f32, tmp_path, capsys):
    rng = np.random.default_rng(6)
    x = np.round(rng.uniform(-40, 60, 2 * 102400 + 333), 2)
    x[rng.choice(len(x), 50, replace=False)] = rng.standard_normal(50)
    path = tmp_path / f"col{suffix}"
    if suffix == ".bin":
        x.astype(np.float32 if f32 else np.float64).tofile(path)
    else:
        _write_csv(path, x[:20000], trailing=True)
    argv = [str(path)] + (["--f32"] if f32 else [])
    got = _cli_lines(cli.main, argv + ["--device", "cpu"], capsys)
    want = _cli_lines(jcli.main, argv, capsys)
    assert got == want
    assert got[-1] == "round-trip: bit-exact OK"


@pytest.mark.parametrize("f32", [False, True])
def test_cli_prints_and_checks_the_host_decode(f32, tmp_path, capsys,
                                              monkeypatch):
    from alp_tpu_torch import container
    rng = np.random.default_rng(7)
    x = np.round(rng.uniform(-40, 60, 102400 + 999), 2)
    path = tmp_path / "col.bin"
    x.astype(np.float32 if f32 else np.float64).tofile(path)
    argv = [str(path), "--device", "cpu"] + (["--f32"] if f32 else [])
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    host = [ln for ln in lines if ln.endswith("(host)")]
    assert [ln.split(":")[0] for ln in host] == ["compress", "decompress"]
    assert re.fullmatch(r"decompress: \d+\.\d{3} GB/s \(host\)", host[1])
    assert lines[-1] == "round-trip: bit-exact OK"

    real = container.decompress_host

    def off_by_one_bit(col):
        out = real(col)
        out.view(np.uint32 if f32 else np.uint64)[-1] ^= 1
        return out

    monkeypatch.setattr(container, "decompress_host", off_by_one_bit)
    assert cli.main(argv) == 1
    captured = capsys.readouterr()
    assert "round-trip: MISMATCH (host)" in captured.err
    assert "bit-exact OK" not in captured.out


def test_cli_without_a_card_exits_nonzero(tmp_path, monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "col.bin"
    np.linspace(0, 1, 5000).tofile(path)
    assert cli.main([str(path)]) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "--device cpu" in captured.err


def test_bench_e2e_exits_nonzero_without_a_card(tmp_path):
    done = subprocess.run(
        [sys.executable, "-m", "alp_tpu_torch.bench_e2e", "--out",
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin",
                          "CUDA_VISIBLE_DEVICES": ""})
    assert done.returncode != 0
    assert done.stdout == "" and not list(tmp_path.iterdir())


def test_bench_e2e_rows_run_on_the_cpu():
    """Every row of ``bench_e2e.rows`` at a small size with the plain
    versions (a rehearsal of the card's run: its speeds mean nothing
    here), its correctness companions and round-trip checks passing."""
    import io as _io

    import torch

    from alp_tpu_torch import bench_e2e
    out = _io.StringIO()
    rows = bench_e2e.rows(torch.device("cpu"), 0, vectors=200,
                          host_vectors=200, dc_vectors=200, out=out)
    queries = [r[0] for r in rows]
    assert len(rows) == len(out.getvalue().splitlines()) - 2 == 64
    # rates are rounded to 0.01 GB/s, which a loaded CPU can fall under
    assert all(len(r) == len(bench_e2e.HEADER) and r[3] >= 0 for r in rows)
    assert queries.count("SUM-scan decode") == 15
    assert queries.count("DECODE") == 2
    assert [r[1] for r in rows if r[0] == "DECOMPRESSION"
            and r[1].startswith("ALP host engine")] == [
        "ALP host engine (OpenMP)", "ALP host engine f32"]
    assert any(r[1].startswith("ALP device e2e") for r in rows)
