"""Competitor codecs: so far the system ``libzstd`` through ctypes
(``zstd_codec``), which plan snapshots also use for their payload."""
