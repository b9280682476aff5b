"""Published full-dataset compression-ratio numbers (bits/value).

Counterpart of ``alp_tpu/utils/published.py``: the same tables.

Transcribed from the reference paper artifact table
(reference publication/tables/table_4.md) so ratio reports can carry
the comparisons this environment cannot reproduce directly:

* ``zstd``: Zstandard v1.5.5 (measured via the ctypes libzstd binding
  when the system library exists, zlib/DEFLATE stand-in otherwise —
  competitors.zstd_codec);
* ``elf``: the Elf codec (measured via competitors.elf_codec, a
  behavioral reimplementation of the reference's Java artifact; these
  published numbers are its full-data parity targets);
* ``alp``: the reference's own full-dataset ALP result — our measured
  column uses the shipped 1024-value samples unless the full corpus is
  mounted (ALP_DATASET_DIR_PATH), so expect sample-vs-full deltas.
"""

# dataset name -> (zstd, elf, alp) published bits/value, table_4.md
TABLE_4 = {
    "Air-Pressure": (9.39, 14.25, 16.43),
    "Basel-Temp": (18.44, 36.85, 30.72),
    "Basel-Wind": (14.66, 36.72, 29.81),
    "Bird-Mig": (21.02, 22.78, 20.14),
    "Btc-Price": (42.08, 36.42, 26.37),
    "City-Temp": (16.77, 17.95, 10.74),
    "Dew-Temp": (25.07, 20.85, 13.40),
    "Bio-Temp": (17.46, 16.66, 10.75),
    "PM10-dust": (7.78, 10.38, 8.56),
    "Stocks-DE": (10.54, 14.41, 11.01),
    "Stocks-UK": (10.28, 12.05, 12.59),
    "Stocks-USA": (8.56, 12.20, 7.90),
    "Wind-dir": (25.53, 25.62, 15.89),
    "Arade/4": (33.90, 34.58, 24.94),
    "Blockchain": (43.97, 41.26, 36.49),
    "CMS/1": (26.56, 27.71, 35.65),
    "CMS/25": (58.27, 51.34, 41.11),
    "CMS/9": (14.73, 14.79, 11.67),
    "Food-prices": (18.32, 17.31, 23.65),
    "Gov/10": (28.09, 30.47, 30.99),
    "Gov/26": (0.23, 3.16, 0.41),
    "Gov/30": (4.48, 7.17, 7.48),
    "Gov/31": (1.63, 4.50, 3.05),
    "Gov/40": (0.46, 3.34, 0.83),
    "Medicare/1": (31.18, 31.87, 39.35),
    "Medicare/9": (15.03, 15.03, 12.26),
    "NYC/29": (27.50, 32.04, 40.38),
    "POI-lat": (59.34, 61.53, 55.74),
    "POI-lon": (60.98, 67.78, 56.56),
    "SD-bench": (11.34, 20.41, 16.21),
}

# suite averages from the same table (ALL AVG. row)
SUITE_AVG = {"gorillas": 41.6, "chimp": 37.7, "chimp128": 28.6,
             "patas": 35.5, "pde": 31.3, "elf": 24.7, "alp": 21.7,
             "zstd": 22.1}


def published(name: str):
    """(zstd, elf, alp) published bits/value for a dataset, or Nones."""
    return TABLE_4.get(name, (None, None, None))


# Full-corpus golden compression-ratio strings, transcribed from the
# reference's hard gate (publication/source_code/include/alp_result.hpp:
# 31-40; asserted by bench_compression_ratio/alp.cpp:236-239 to two
# decimals); the issue-24 full files ship with the reference data.
GOLDEN_FULL_RATIO = {
    "Air-Pressure": "16.43", "Arade/4": "24.94", "Basel-Temp": "30.72",
    "Basel-Wind": "29.81", "Bird-Mig": "20.14", "Btc-Price": "26.37",
    "Blockchain": "36.49", "City-Temp": "10.74", "CMS/1": "35.65",
    "CMS/9": "11.67", "CMS/25": "41.11", "Dew-Temp": "13.40",
    "Bio-Temp": "10.75", "Food-prices": "23.65", "Gov/10": "30.99",
    "Gov/26": "0.41", "Gov/30": "7.48", "Gov/31": "3.05",
    "Gov/40": "0.83", "Medicare/1": "39.35", "Medicare/9": "12.26",
    "PM10-dust": "8.56", "NYC/29": "40.38", "SD-bench": "16.21",
    "Stocks-DE": "11.01", "Stocks-UK": "12.59", "Stocks-USA": "7.90",
    "Wind-dir": "15.89",
}

# The issue-24 regression goldens (reference benchmarks/result/
# compression_ratio/double/issue_24.csv; full data ships in data/issue/).
GOLDEN_ISSUE_RATIO = {
    "issue_24_replicated_data": "32.20",
    "issue_24_actual_data": "33.56",
}

# Paper table 7 — the float (SP) ML-weights suite, bits/value
# (reference publication/tables/table_7.md:3-6): dataset ->
# (gorillas, chimp, chimp128, patas, alp, zstd).  The binaries are not
# in-image; these are the parity targets measured rows gate against
# when SP_DATASET_DIR_PATH-style corpora are mounted.
TABLE_7_SP = {
    "Dino-Vitb16": (34.11, 33.42, 33.43, 45.81, 28.78, 29.74),
    "GPT2": (34.11, 33.46, 33.48, 45.63, 28.01, 29.69),
    "Grammarly-lg": (34.11, 33.42, 33.43, 45.51, 29.16, 29.65),
    "W2V Tweets": (32.32, 33.50, 33.51, 45.60, 28.86, 29.65),
}

# Repo-runner full-data ALP bits/value for the SP suite (reference
# benchmarks/result/compression_ratio/float/sp_dataset.csv — the
# benchmark.hpp cost model, which differs slightly from the paper
# table's overhead accounting above).
SP_ALP_RUNNER = {
    "Dino-Vitb16": 28.24, "GPT2": 27.69, "Grammarly-lg": 27.73,
    "W2V Tweets": 28.26,
}

# Hurricane-Isabel full-data ALP bits/value (reference benchmarks/
# result/compression_ratio/float/hurricane_isabel_dataset.csv; the
# 20-column f32 suite, data gated on HURRICANE_ISABEL_DATASET_DIR_PATH).
HURRICANE_ALP_RUNNER = {
    "CLOUDf48": 9.36, "CLOUDf48-log10": 22.39, "PRECIPf48": 29.91,
    "PRECIPf48-log10": 24.77, "Pf48": 26.21, "QCLOUDf48": 4.08,
    "QCLOUDf48-log10": 14.06, "QGRAUPf48": 30.60,
    "QGRAUPf48-log10": 25.04, "QICEf48": 7.54, "QICEf48-log10": 17.21,
    "QRAINf48": 30.47, "QRAINf48-log10": 25.08, "QSNOWf48": 29.96,
    "QSNOWf48-log10": 24.30, "QVAPORf48": 25.30, "TCf48": 22.86,
    "Uf48": 27.44, "Vf48": 27.25, "Wf48": 28.06,
}
