"""Seeded synthetic genomes and reads.

Simulation-as-ground-truth, following the reference's evaluation strategy
(reference: eval/SuffixArraySim/SuffixArraySimulatedSequences.java:78-136):
uniform, GC-biased and repeat genomes from a seeded RNG, plus a read
simulator with substitution errors for end-to-end aligner checks
(reference: eval/Aligner/AlignmentQuality.java compares SAM vs truth).
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def uniform_genome(n: int, seed: int = 1212121) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return _BASES[rng.integers(0, 4, n)]


def gc_biased_genome(n: int, gc: float = 0.7, seed: int = 1212121) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p_each = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
    return _BASES[rng.choice(4, size=n, p=p_each)]


def repeat_genome(n: int, period: int = 1000, seed: int = 1212121) -> np.ndarray:
    rng = np.random.default_rng(seed)
    unit = _BASES[rng.integers(0, 4, period)]
    reps = (n + period - 1) // period
    return np.tile(unit, reps)[:n]


def benchmark_genome(n: int, seed: int = 20260816) -> np.ndarray:
    """Deterministic benchmark genome with realistic hardness: GC-biased
    background plus duplicated segments and tandem repeats (~15% of bases),
    so the suffix array has non-trivial LCP structure and the PWL index
    sees real prediction error (a uniform random genome is a trivially
    easy, dishonest benchmark for a learned index).
    """
    rng = np.random.default_rng(seed)
    p_each = np.array([0.2, 0.3, 0.3, 0.2])  # 60% GC
    g = np.empty(n, dtype=np.uint8)
    for lo in range(0, n, 1 << 27):  # chunked: rng.choice allocs float64 n
        hi = min(lo + (1 << 27), n)
        g[lo:hi] = _BASES[rng.choice(4, size=hi - lo, p=p_each)]
    # segmental duplications: copy random 2-20kb windows elsewhere
    dup_bases = int(n * 0.10)
    placed = 0
    while placed < dup_bases:
        seg = int(rng.integers(2_000, 20_001))
        src = int(rng.integers(0, max(n - seg, 1)))
        dst = int(rng.integers(0, max(n - seg, 1)))
        g[dst : dst + seg] = g[src : src + seg]
        placed += seg
    # tandem repeats: short units repeated in runs
    tr_bases = int(n * 0.05)
    placed = 0
    while placed < tr_bases:
        unit = int(rng.integers(2, 64))
        copies = int(rng.integers(5, 50))
        seg = unit * copies
        dst = int(rng.integers(0, max(n - seg, 1)))
        g[dst : dst + seg] = np.tile(g[dst : dst + unit], copies)
        placed += seg
    return g


_COMP = np.zeros(256, dtype=np.uint8)
for a, b in zip(b"ACGT", b"TGCA"):
    _COMP[a] = b


def revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[::-1]]


def simulate_reads(
    genome: np.ndarray,
    num: int,
    length: int,
    sub_rate: float = 0.0,
    rc_prob: float = 0.5,
    seed: int = 7,
):
    """Sample reads with optional substitution errors.

    Returns (reads [num, length] ascii uint8, true_pos [num], is_rc [num]).
    """
    rng = np.random.default_rng(seed)
    n = genome.shape[0]
    pos = rng.integers(0, n - length + 1, num)
    reads = genome[pos[:, None] + np.arange(length)]
    if sub_rate > 0:
        mask = rng.random((num, length)) < sub_rate
        shift = rng.integers(1, 4, (num, length))
        code = np.searchsorted(_BASES, reads)  # ACGT are sorted ascii
        reads = np.where(mask, _BASES[(code + shift) % 4], reads)
    is_rc = rng.random(num) < rc_prob
    reads = np.where(is_rc[:, None], np.stack([revcomp(r) for r in reads]), reads)
    return reads, pos, is_rc


def simulate_reads_indel(
    genome: np.ndarray,
    num: int,
    length: int,
    sub_rate: float = 0.01,
    indel_rate: float = 0.005,
    max_indel: int = 3,
    rc_prob: float = 0.5,
    seed: int = 7,
):
    """Reads with substitutions AND short insertions/deletions (exercises
    the affine-gap paths of the extension engine). Returns (list of ascii
    arrays — lengths stay `length` by re-trimming —, true_pos, is_rc)."""
    rng = np.random.default_rng(seed)
    n = genome.shape[0]
    margin = length + max_indel * 4
    pos = rng.integers(0, n - margin, num)
    reads, is_rc = [], []
    for i in range(num):
        src = genome[pos[i] : pos[i] + margin].copy()
        out = []
        j = 0
        while len(out) < length and j < len(src):
            roll = rng.random()
            if roll < indel_rate / 2:      # deletion from reference
                j += int(rng.integers(1, max_indel + 1))
                continue
            if roll < indel_rate:          # insertion into read
                for _ in range(int(rng.integers(1, max_indel + 1))):
                    out.append(_BASES[rng.integers(0, 4)])
            b = src[j]
            if rng.random() < sub_rate:
                code = int(np.searchsorted(_BASES, b))
                b = _BASES[(code + int(rng.integers(1, 4))) % 4]
            out.append(b)
            j += 1
        read = np.array(out[:length], dtype=np.uint8)
        if len(read) < length:  # pad from genome tail (rare)
            read = np.concatenate([read, src[j : j + length - len(read)]])
        rc = rng.random() < rc_prob
        if rc:
            read = revcomp(read)
        reads.append(read)
        is_rc.append(rc)
    return reads, pos, np.asarray(is_rc)


def write_fastq(path: str, reads, names: list[str] | None = None,
                qual: int = ord("I")):
    """reads: [num, length] ascii uint8 array, or a list of 1-D ascii
    arrays with mixed lengths (the reference reader handles arbitrary
    per-record lengths, src/align.cpp:174-190)."""
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            r = np.asarray(r, np.uint8)
            name = names[i] if names else f"read{i + 1}"
            f.write(b"@" + name.encode() + b"\n")
            f.write(r.tobytes() + b"\n+\n" + bytes([qual]) * len(r) + b"\n")
