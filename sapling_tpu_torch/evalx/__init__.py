"""Evaluation helpers (host only): the index's memory accounting."""
