"""Evaluation helpers (host only): the index's memory accounting and the
(SA rank, k-mer) samples of the learned-index research pipeline."""
