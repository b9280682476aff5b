"""Dataset registry with golden per-first-vector metadata.

Counterpart of ``alp_tpu/utils/datasets.py``: the same columns, golden
tuples and directory convention.

Python port of the reference dataset descriptor tables
(reference data/include/double/alp_dataset.hpp:8-287,
generated_columns.hpp:7-82, edge_case.hpp, float/test.hpp, float/sp.hpp,
float/edge_case.hpp, double/issue_dataset.hpp).  The golden
``(factor, exponent, exceptions_count, bit_width)`` tuples are the values
asserted by the reference unit tests on the first 1024 values of each
dataset; they are parity targets for this framework's tests.

Dataset files are read from the repository's ``data/`` directory by
default (the JAX package's default is a checkout of the reference outside
the repository); set ``ALP_TPU_DATA_DIR`` to point at a checkout of the
ALP ``data/`` directory, and ``ALP_DATASET_DIR_PATH`` for full binary
datasets (same convention as the reference, column.hpp:53-59).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

_DEFAULT_DATA_DIR = pathlib.Path(__file__).resolve().parents[2] / "data"


def data_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get("ALP_TPU_DATA_DIR", _DEFAULT_DATA_DIR))


def binary_dir() -> pathlib.Path | None:
    p = os.environ.get("ALP_DATASET_DIR_PATH")
    if p:
        return pathlib.Path(p)
    full = data_dir() / "full_data"
    return full if full.exists() else None


@dataclasses.dataclass(frozen=True)
class Column:
    """Mirror of alp_bench::ALPColumnDescriptor (column.hpp:30-40)."""
    id: int
    name: str
    csv_rel_path: str            # relative to data_dir(); "" if binary-only
    binary_name: str = ""        # file name under binary_dir(); "" if none
    factor: int = 0
    exponent: int = 0
    exceptions_count: int = 0
    bit_width: int = 0
    suitable_for_cutting: bool = False
    dtype: str = "float64"

    @property
    def csv_path(self) -> pathlib.Path | None:
        return data_dir() / self.csv_rel_path if self.csv_rel_path else None

    @property
    def binary_path(self) -> pathlib.Path | None:
        if not self.binary_name:
            return None
        dirs = [binary_dir()]
        if self.dtype == "float32":
            # hurricane-isabel files live under their own env dir
            # (column.hpp:56-58)
            dirs.append(hurricane_dir())
        for bd in dirs:
            if bd is not None:
                p = bd / self.binary_name
                if p.exists():
                    return p
        return None


def _d(id, name, csv, binary, factor, exponent, exc, bw, cut=False):
    return Column(id, name, f"samples/{csv}" if csv else "", binary,
                  factor, exponent, exc, bw, cut, "float64")


# Golden values from data/include/double/alp_dataset.hpp:8-287.
ALP_DATASET = [
    _d(1, "Air-Pressure", "neon_air_pressure.csv", "neon_air_pressure.bin", 14, 9, 3, 16),
    _d(2, "Arade/4", "arade4.csv", "arade4.bin", 14, 10, 8, 24),
    _d(3, "Basel-Temp", "basel_temp_f.csv", "basel_temp_f.bin", 14, 7, 47, 28),
    _d(4, "Basel-Wind", "basel_wind_f.csv", "basel_wind_f.bin", 14, 7, 9, 29),
    _d(5, "Bird-Mig", "bird_migration_f.csv", "bird_migration_f.bin", 14, 9, 2, 17),
    _d(6, "Btc-Price", "bitcoin_f.csv", "bitcoin_f.bin", 14, 10, 10, 25),
    _d(7, "Blockchain", "bitcoin_transactions_f.csv", "bitcoin_transactions_f.bin", 14, 10, 11, 30),
    _d(8, "City-Temp", "city_temperature_f.csv", "city_temperature_f.bin", 14, 13, 0, 11),
    _d(9, "CMS/1", "cms1.csv", "cms1.bin", 14, 5, 10, 41),
    _d(10, "CMS/9", "cms9.csv", "cms9.bin", 16, 16, 2, 10),
    _d(11, "CMS/25", "cms25.csv", "cms25.bin", 14, 4, 6, 42),
    _d(12, "Dew-Temp", "neon_dew_point_temp.csv", "neon_dew_point_temp.bin", 14, 11, 6, 13),
    _d(13, "Bio-Temp", "neon_bio_temp_c.csv", "neon_bio_temp_c.bin", 14, 12, 0, 10),
    _d(14, "Food-prices", "food_prices.csv", "food_prices.bin", 16, 12, 46, 20),
    _d(15, "Gov/10", "gov10.csv", "gov10.bin", 3, 1, 72, 27),
    _d(16, "Gov/26", "gov26.csv", "gov26.bin", 18, 18, 0, 0),
    _d(17, "Gov/30", "gov30.csv", "gov30.bin", 18, 18, 4, 0),
    _d(18, "Gov/31", "gov31.csv", "gov31.bin", 18, 18, 1, 0),
    _d(19, "Gov/40", "gov40.csv", "gov40.bin", 18, 18, 3, 0),
    _d(20, "Medicare/1", "medicare1.csv", "medicare1.bin", 14, 5, 37, 38),
    _d(21, "Medicare/9", "medicare9.csv", "medicare9.bin", 16, 16, 3, 10),
    _d(22, "PM10-dust", "neon_pm10_dust.csv", "neon_pm10_dust.bin", 14, 11, 0, 8),
    _d(23, "NYC/29", "nyc29.csv", "nyc29.bin", 14, 1, 5, 42),
    _d(24, "POI-lat", "poi_lat.csv", "poi_lat.bin", 16, 0, 157, 55, True),
    _d(25, "POI-lon", "poi_lon.csv", "poi_lon.bin", 16, 0, 199, 56, True),
    _d(26, "SD-bench", "ssd_hdd_benchmarks_f.csv", "ssd_hdd_benchmarks_f.bin", 14, 13, 0, 17),
    _d(27, "Stocks-DE", "stocks_de.csv", "stocks_de.bin", 14, 11, 5, 10),
    _d(28, "Stocks-UK", "stocks_uk.csv", "stocks_uk.bin", 14, 13, 0, 9),
    _d(29, "Stocks-USA", "stocks_usa_c.csv", "stocks_usa_c.bin", 14, 12, 0, 7),
    _d(30, "Wind-dir", "neon_wind_dir.csv", "neon_wind_dir.bin", 14, 12, 0, 16),
]

# Synthetic bit-width sweeps (generated_columns.hpp:7-82).  Golden bit_width
# per column id; a few ids deliberately map to a different bw (quirks kept).
_GENERATED_BW = {i: i for i in range(65)}
_GENERATED_BW.update({43: 60, 52: 56, 53: 63, 54: 55, 55: 56, 56: 57,
                      57: 58, 58: 59, 59: 60, 60: 61, 61: 62, 62: 63, 63: 63})

GENERATED_COLUMNS = [
    Column(i, f"bw{i}", f"generated/generated_doubles_bw{i}.csv", "",
           0, 0, 0, _GENERATED_BW[i], False, "float64")
    for i in range(65)
]

# edge_case.hpp / float/edge_case.hpp
EDGE_CASE = [
    Column(1, "edge_case", "edge_case/edge_case.csv", "", 0, 0, 12, 0, True,
           "float64"),
]
FLOAT_EDGE_CASE = [
    Column(1, "avx512dq", "edge_case/avx512dq.csv", "", 0, 0, 192, 0, True,
           "float32"),
]

# float/test.hpp
FLOAT_TEST_DATASET = [
    Column(0, "Arade/4", "samples/arade4.csv", "", 0, 0, 0, 0, False, "float32"),
    Column(1, "test_0", "float/test_0.csv", "", 0, 0, 0, 4, False, "float32"),
    Column(2, "test_1", "float/test_1.csv", "", 0, 0, 0, 10, False, "float32"),
    Column(3, "test_2", "float/test_2.csv", "", 0, 0, 0, 17, False, "float32"),
    Column(4, "test_3", "float/test_3.csv", "", 0, 0, 0, 0, False, "float32"),
]

# double/alp_dataset.hpp get_double_test_dataset
DOUBLE_TEST_DATASET = [
    Column(0, "test_0", "double/test_0.csv", "", 0, 0, 0, 0, False, "float64"),
]

# double/issue_dataset.hpp:8-30 — GitHub issue 24 regression columns.
ISSUE_DATASET = [
    Column(0, "issue_24_replicated_data",
           "issue/issue_24_102400_values.csv", "", 0, 0, 0, 0, False,
           "float64"),
    Column(1, "issue_24_actual_data", "issue/ShapesAll_TEST.csv", "",
           0, 0, 0, 0, False, "float64"),
]

# float/hurricane_isabel.hpp:10-33 — 20 f32 columns, binary-only; files
# located via HURRICANE_ISABEL_DATASET_DIR_PATH (column.hpp:56-58).
_HURRICANE_NAMES = [
    "CLOUDf48", "CLOUDf48-log10", "PRECIPf48", "PRECIPf48-log10", "Pf48",
    "QCLOUDf48", "QCLOUDf48-log10", "QGRAUPf48", "QGRAUPf48-log10",
    "QICEf48", "QICEf48-log10", "QRAINf48", "QRAINf48-log10", "QSNOWf48",
    "QSNOWf48-log10", "QVAPORf48", "TCf48", "Uf48", "Vf48", "Wf48",
]
HURRICANE_ISABEL = [
    Column(i + 1, name, "",
           name.replace("-log10", ".log10") + ".bin.f32",
           0, 0, 0, 0, False, "float32")
    for i, name in enumerate(_HURRICANE_NAMES)
]


def hurricane_dir() -> pathlib.Path | None:
    p = os.environ.get("HURRICANE_ISABEL_DATASET_DIR_PATH")
    return pathlib.Path(p) if p else None


# evalimplsts.hpp:8-17 — implementation-study column (data-gated: the
# CSV is not shipped in the repo; path via EVALIMPLSTS_CSV_PATH).
EVALIMPLSTS = [
    Column(0, "active_power", "evalimplsts/active_power.csv", "",
           0, 0, 0, 0, True, "float64"),
]


# float/sp.hpp — ML-weights suites (binary-only, full datasets).
SP_DATASETS = [
    Column(1, "Dino-Vitb16", "", "sp_dino_vitb16.bin", 0, 0, 0, 0, True, "float32"),
    Column(2, "GPT2", "", "sp_gpt2.bin", 0, 0, 0, 0, True, "float32"),
    Column(3, "Grammarly-lg", "", "sp_grammarly_coedit_lg.bin", 0, 0, 0, 0, True, "float32"),
    Column(4, "W2V Tweets", "", "sp_w2v.bin", 0, 0, 0, 0, True, "float32"),
]


def all_golden_columns():
    """Columns with CSV samples + golden (exc_count, bit_width) to assert."""
    return (ALP_DATASET + GENERATED_COLUMNS + EDGE_CASE + FLOAT_TEST_DATASET
            + DOUBLE_TEST_DATASET + FLOAT_EDGE_CASE)
