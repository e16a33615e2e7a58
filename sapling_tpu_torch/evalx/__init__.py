"""Evaluation helpers (host only, copies of sapling_tpu/evalx/): the
index's memory accounting, (SA rank, k-mer) samples, the k-mer spectrum,
per-bucket error statistics, SAM-vs-truth alignment quality and the
plots (plots.py needs matplotlib; nothing else here does)."""
