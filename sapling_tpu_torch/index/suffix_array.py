"""Suffix-array substrate: build (native SA-IS) + derived arrays.

Replaces the reference's in-memory DC3 (src/sa.h:82-183) and its k-threshold
RMQ (src/sa.h:33-57) with:
  * native SA-IS + Kasai (sapling_tpu_torch.native),
  * vectorized forward/backward run-length arrays over `lcp >= k`, which
    answer every KRMQ query the reference ever makes in O(1) closed form
    (used by the build-time error audit and the aligner's hit counting).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..native import build_suffix_array, lcp_kasai


@dataclass
class SuffixData:
    sa: np.ndarray    # rank -> pos  (the reference calls this `rev`)
    inv: np.ndarray   # pos -> rank  (the reference's lsa.inv)
    lcp: np.ndarray   # lcp[r] = LCP(suffix@rank r, suffix@rank r+1), len n-1

    @property
    def n(self) -> int:
        return int(self.inv.shape[0])


def build_suffix_data(seq_ascii: np.ndarray, pos_dtype=None) -> SuffixData:
    """SA + inv + LCP for an ASCII ACGT genome."""
    sa = build_suffix_array(seq_ascii, pos_dtype)
    inv, lcp = lcp_kasai(seq_ascii, sa)
    return SuffixData(sa=sa, inv=inv, lcp=lcp)


def lcp_ge_k_runs(lcp: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward/backward run lengths of `lcp >= k`.

    fwd[i]  = #consecutive j >= i with lcp[j] >= k     (reference krmqb,
              src/sa.h:33-43)
    bwd[i]  = #consecutive j <= i with lcp[j] >= k

    These answer the reference's KRMQ queries in closed form:
      queryLcpK(a, b), a<b  <=>  fwd[a] >= b - a
    and give getError's bounded shifts (src/sapling_api.h:309-337) as
      y < p: y' = min(p, y + fwd[y])        (fwd[y]=0 when y >= len(lcp))
      y > p: y' = max(p, y - bwd[y-1])
    """
    m = lcp.shape[0]
    ok = lcp >= k
    idx = np.arange(m, dtype=np.int64)
    nf = np.where(~ok, idx, m)  # position of this element if it breaks the run
    # next break at-or-after i:
    next_break = np.minimum.accumulate(nf[::-1])[::-1]
    fwd = (next_break - idx).astype(lcp.dtype)
    pf = np.where(~ok, idx, -1)
    prev_break = np.maximum.accumulate(pf)
    bwd = (idx - prev_break).astype(lcp.dtype)
    return fwd, bwd


def fwd_runs_from_mask(ok: np.ndarray) -> np.ndarray:
    """Forward run lengths of a boolean mask, int32-capped (the memory-
    lean form of lcp_ge_k_runs' fwd for m < 2^32 — uint32 index temps
    instead of int64)."""
    m = ok.shape[0]
    idx = np.arange(m, dtype=np.uint32)
    nf = np.where(~ok, idx, np.uint32(m))
    nb = np.minimum.accumulate(nf[::-1])[::-1]
    del nf
    runs = nb - idx
    np.minimum(runs, np.uint32(np.iinfo(np.int32).max), out=runs)
    return runs.astype(np.int32)


def fwd_runs_from_rank_kmers(kmers: np.ndarray, inv: np.ndarray,
                             n: int) -> np.ndarray:
    """lcp>=k forward runs derived WITHOUT an LCP array: for two
    full-length suffixes, lcp(rank r, rank r+1) >= k iff their leading
    k-mers are equal; a suffix shorter than k can never reach lcp k
    (lcp <= its length < k). Lets a saved artifact (codes + inv) be
    re-audited — e.g. a bucket-count retable — without re-running
    Kasai. Returns int32 [n-1] matching lcp_ge_k_runs(lcp, k)[0].

    kmers: int64 [n-k+1] k-mer value per position; inv: [n] pos->rank."""
    m = kmers.shape[0]
    karr = np.empty(n, dtype=np.int64)
    karr[np.asarray(inv[:m], dtype=np.int64)] = kmers
    # short suffixes: distinct negative sentinels — never equal to any
    # k-mer value or to each other
    karr[np.asarray(inv[m:], dtype=np.int64)] = \
        -1 - np.arange(n - m, dtype=np.int64)
    ok = karr[:-1] == karr[1:]
    del karr
    return fwd_runs_from_mask(ok)


def pack_bitmask(bits: np.ndarray, pad_words: int = 4) -> np.ndarray:
    """Pack a boolean array into uint32 words, bit i at position 31-(i%32)
    of word i//32 (big-endian within word, matching the 2-bit genome pack)."""
    n = bits.shape[0]
    n_words = (n + 31) // 32
    buf = np.zeros(n_words * 32, dtype=np.uint32)
    buf[:n] = bits.astype(np.uint32)
    buf = buf.reshape(n_words, 32)
    shifts = np.uint32(31) - np.arange(32, dtype=np.uint32)
    words = np.bitwise_or.reduce(buf << shifts, axis=1).astype(np.uint32)
    return np.concatenate([words, np.zeros(pad_words, dtype=np.uint32)])


def build_llcp_rlcp(lcp: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """llcp/rlcp midpoint-tree tables for the Manber-Myers pruned binary
    search over the rank interval (0, n-1).

    llcp[mid] = min lcp[lo..mid-1] and rlcp[mid] = min lcp[mid..hi-1]
    for every midpoint mid of the (lo, hi) recursion tree — the
    semantics of the reference's calcLLCP/calcRLCP
    (src/binarysearch.cpp:60-88), except built over the interval the
    search actually uses: the reference initializes over (0, n-k)
    (:84-86) yet searches (0, n-1) (:163), a latent mismatch in code its
    own bQuery never calls.

    Level-order traversal with a sparse range-min table: O(n log n) time
    and memory (int32), fine for baseline-scale genomes.
    """
    lcp = np.asarray(lcp)
    m = lcp.shape[0]
    assert m == n - 1, (m, n)
    # sparse table: sp[j][i] = min lcp[i : i + 2^j]
    levels = [lcp.astype(np.int32)]
    j = 1
    while (1 << j) <= m:
        prev = levels[-1]
        half = 1 << (j - 1)
        levels.append(np.minimum(prev[:-half], prev[half:]))
        j += 1

    def rmin(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """min lcp[a:b] vectorized; every range is nonempty here."""
        w = b - a
        j = (np.log2(np.maximum(w, 1))).astype(np.int64)
        out = np.empty(a.shape[0], np.int32)
        for jj in np.unique(j):
            sel = j == jj
            sp = levels[jj]
            out[sel] = np.minimum(sp[a[sel]], sp[b[sel] - (1 << jj)])
        return out

    llcp = np.zeros(n, dtype=np.int32)
    rlcp = np.zeros(n, dtype=np.int32)
    los = np.array([0], dtype=np.int64)
    his = np.array([n - 1], dtype=np.int64)
    while los.size:
        sel = his > los + 2
        los, his = los[sel], his[sel]
        if not los.size:
            break
        mids = (los + his) >> 1
        llcp[mids] = rmin(los, mids)
        rlcp[mids] = rmin(mids, his)
        los = np.concatenate([los, mids])
        his = np.concatenate([mids, his])
    return llcp, rlcp
