"""Per-bucket error analysis and best/worst-bucket highlighting.

Equivalents of eval/ErrorsPerBin/PerBinErrors.java:5-60 (per-bucket
max/mean/median |error| and global 95th percentile) and
eval/HighlightBins/BestAndWorstBins.java:10-50 (rank buckets by an error
statistic, extract the extremes with their (kmer, rank) scatter data).
"""

from __future__ import annotations

import numpy as np

from ..index.pwl import ErrorAudit
from ..ops.pack import ALPHA


def per_bin_errors(audit: ErrorAudit, kmers: np.ndarray, k: int,
                   buckets: int):
    """Per-bucket stats plus the global 95th percentile of |error|
    (PerBinErrors.java computes the same four quantities)."""
    stats = audit.per_bin_stats(kmers, ALPHA * k, buckets)
    a = np.abs(audit.errors.astype(np.int64))
    stats["p95"] = float(np.percentile(a, 95)) if a.size else 0.0
    return stats


def best_and_worst_bins(audit: ErrorAudit, kmers: np.ndarray, k: int,
                        buckets: int, count: int = 5, by: str = "max"):
    """Indices of the `count` lowest- and highest-error buckets, ranked by
    the chosen statistic over non-empty bins."""
    stats = per_bin_errors(audit, kmers, k, buckets)
    key = np.asarray(stats[by], dtype=np.float64)
    nz = np.flatnonzero(stats["count"] > 0)
    order = nz[np.argsort(key[nz], kind="stable")]
    return {
        "best": order[:count].tolist(),
        "worst": order[-count:][::-1].tolist(),
        "stats": stats,
    }


def bin_scatter(kmers: np.ndarray, ranks: np.ndarray, k: int, buckets: int,
                bin_index: int):
    """(kmer, rank) points falling in one bucket — the scatter the
    reference plots per highlighted bin (HighlightBins/plot.sh)."""
    shift = ALPHA * k - buckets
    sel = (kmers >> shift) == bin_index
    return kmers[sel], np.asarray(ranks)[sel]
