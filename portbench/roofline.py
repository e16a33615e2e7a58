"""Peaks of the card and the least bytes a lookup request moves.

The bytes are counted from a request's queries alone, so that every
design of the program is held to the same work: whatever a design reads
besides (the index, records, the genome to verify a hit) is its own
choice, and the count below is a floor of what any design must move.

  * each query's packed words, 8 bytes for every 16 bases, read once;
  * each answer, an int64 position, written once;
  * for the learned index (plQuery) also each query's k-mer, 8 bytes,
    read once, and the distinct PWL checkpoints the batch's k-mers name,
    buckets b and b + 1 of each k-mer's bucket b, 16 bytes each (x and y
    as the reference's `.sap` file stores them).
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the card's full 700 W limit
HBM_BYTES_PER_S = 3.35e12
BASES_PER_WORD = 16
WORD_BYTES = 8
POSITION_BYTES = 8
KMER_BYTES = 8
CHECKPOINT_BYTES = 16


def buckets_for(n: int, max_mem: int) -> int:
    """log2 of the PWL bucket count the reference picks for a genome of n
    bases from maxMem (sapling_api.h:387-391): the smallest b with
    2^b * maxMem * 2 > n."""
    b = 1
    while (1 << b) * max_mem * 2 <= n:
        b += 1
    return b


def io_bytes(rows: np.ndarray) -> int:
    """The queries' packed words read and their positions written."""
    count, length = rows.shape
    words = -(-length // BASES_PER_WORD)
    return count * (words * WORD_BYTES + POSITION_BYTES)


def kmers(rows: np.ndarray, k: int) -> np.ndarray:
    """int64 k-mers of queries of length >= k: the first k bases, 2 bits
    each, the first the most significant."""
    if rows.shape[1] < k:
        raise ValueError(f"queries of {rows.shape[1]} bases have no {k}-mer")
    key = np.zeros(rows.shape[0], dtype=np.int64)
    for j in range(k):
        key = (key << 2) | rows[:, j].astype(np.int64)
    return key


def checkpoints(rows: np.ndarray, k: int, buckets: int) -> int:
    """The distinct PWL checkpoints the queries' k-mers name."""
    b = kmers(rows, k) >> (2 * k - buckets)
    return int(np.unique(np.concatenate([b, b + 1])).size)


def plquery_bytes(rows: np.ndarray, k: int, buckets: int) -> int:
    """The least bytes of a plQuery request over these queries."""
    return (io_bytes(rows) + rows.shape[0] * KMER_BYTES
            + checkpoints(rows, k, buckets) * CHECKPOINT_BYTES)


def binsearch_bytes(rows: np.ndarray) -> int:
    """The least bytes of a binary-search request over these queries."""
    return io_bytes(rows)
