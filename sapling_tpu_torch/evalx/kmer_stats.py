"""k-mer distinctness/uniqueness statistics from the LCP array.

Equivalent of eval/CountUniqueKmers/count.cpp:42-75, which scans the LCP
array once to derive, for every k up to a cap:
  * how many DISTINCT k-mers occur in the genome, and
  * how many of them are UNIQUE (occur exactly once).

Identities (lcp[r] = LCP between rank r and r+1, with lcp[-1]=lcp[n-1]=0
conceptually):
  distinct(k) = #{ r : suffix r has >= k chars and lcp[r-1] < k }
              (each run of lcp >= k shares one k-mer; count run starts)
  unique(k)   = #{ r : len ok, lcp[r-1] < k and lcp[r] < k }
"""

from __future__ import annotations

import numpy as np


def kmer_spectrum(lcp: np.ndarray, n: int, max_k: int = 1000):
    """Returns dict with arrays of length max_k (index = k-1):
    distinct[k-1], unique[k-1], total[k-1] (= n-k+1 genome k-mer slots)."""
    lcp = np.asarray(lcp, dtype=np.int64)
    cap = max_k
    # pad lcp with 0 on both sides: lcp_at(r-1) for r=0 is 0
    left = np.concatenate([[0], lcp])           # left[r] = lcp(r-1, r)
    right = np.concatenate([lcp, [0]])          # right[r] = lcp(r, r+1)
    # suffix length at rank r: need sa (rank->pos); but counts by k only
    # need how many suffixes have length >= k: that's n - k + 1 of them.
    # Count, for each threshold k, ranks where max(left,right) < k (unique)
    # and left < k (run starts / distinct) — via histograms.
    lc = np.minimum(left, cap)
    mx = np.minimum(np.maximum(left, right), cap)
    hist_l = np.bincount(lc, minlength=cap + 1)
    hist_m = np.bincount(mx, minlength=cap + 1)
    # #ranks with left < k = cumsum(hist_l)[k-1]
    cum_l = np.cumsum(hist_l)
    cum_m = np.cumsum(hist_m)
    ks = np.arange(1, cap + 1)
    # Ranks whose suffix is shorter than k can't host a k-mer, yet both
    # cumulative counts include them: a suffix of length L < k has
    # lcp <= L < k against BOTH neighbors (an LCP never exceeds the
    # shorter suffix), so it always lands in "left < k" (a run start in
    # cum_l) and in "max(left,right) < k" (a unique in cum_m). For
    # threshold k the too-short suffixes are exactly those starting at
    # the last k-1 text positions — k-1 of them — so subtracting k-1
    # from each count removes them exactly.
    distinct = cum_l[ks - 1] - (ks - 1)
    unique = cum_m[ks - 1] - (ks - 1)
    total = np.maximum(np.int64(0), np.int64(lcp.shape[0] + 1) - ks + 1)
    # clamp: for k > n the formulas go negative
    distinct = np.maximum(distinct, 0)
    unique = np.maximum(unique, 0)
    return {"k": ks, "distinct": distinct, "unique": unique, "total": total}
