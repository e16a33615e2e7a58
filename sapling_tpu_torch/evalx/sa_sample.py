"""(SA rank, k-mer value) sampling for learned-index research and plots.

Equivalent of NN/sampleSa.cpp:42-74 (per-position dump feeding the NN
pipeline) and eval/SuffixArraySample/sampleSa.cpp (strided ~50k-point
sample for SA-shape plots) — one vectorized function covering both.
"""

from __future__ import annotations

import numpy as np

from ..ops.pack import kmers_scan


def sample_sa(codes: np.ndarray, inv: np.ndarray, k: int = 21,
              stride: int = 1):
    """Returns (ranks, kmers): rank = inv[i], kmer = hash(codes[i:i+k]),
    for i = 0, stride, 2*stride, ... over all n-k+1 positions."""
    kmers = kmers_scan(codes, k)
    m = kmers.shape[0]
    sel = np.arange(0, m, stride)
    return np.asarray(inv[:m])[sel].astype(np.int64), kmers[sel]


def sample_for_plot(codes: np.ndarray, inv: np.ndarray, k: int = 21,
                    target_points: int = 50_000):
    """Strided sample sized for plotting (reference:
    eval/SuffixArraySample/sampleSa.cpp:64 uses size/50000)."""
    m = max(codes.shape[0] - k + 1, 1)
    stride = max(m // target_points, 1)
    return sample_sa(codes, inv, k, stride)
