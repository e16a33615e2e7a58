"""The configurations' genomes, made from their seeds.

A frozen copy of the port's `sim.genomes.benchmark_genome`: a GC-biased
background, then segmental duplications (windows copied elsewhere, exact)
and tandem repeats (a short unit repeated in a run), drawn from one
numpy generator in the same order, so the same parameters give the same
bytes. It stands in for a published assembly, which the repository does
not hold. The benchmark keeps its own copy so that a change to the
program cannot change the data it is measured on.

A genome is made once in a checkout and kept under the benchmark's cache
(`cached_genome`), memory-mapped by later runs.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE = np.zeros(256, dtype=np.uint8)
_CODE[_BASES] = np.arange(4, dtype=np.uint8)
_CHUNK = 1 << 27


def make_genome(spec: dict) -> np.ndarray:
    """The ASCII genome (uint8 [length] of A, C, G, T) a configuration's
    `genome` object describes."""
    n = int(spec["length"])
    rng = np.random.default_rng(int(spec["seed"]))
    p = np.asarray(spec["base_probabilities"], dtype=np.float64)
    g = np.empty(n, dtype=np.uint8)
    for lo in range(0, n, _CHUNK):
        hi = min(lo + _CHUNK, n)
        g[lo:hi] = _BASES[rng.choice(4, size=hi - lo, p=p)]
    seg_lo, seg_hi = spec["duplication_bases"]
    target, placed = int(n * spec["duplication_share"]), 0
    while placed < target:
        seg = int(rng.integers(seg_lo, seg_hi + 1))
        src = int(rng.integers(0, max(n - seg, 1)))
        dst = int(rng.integers(0, max(n - seg, 1)))
        g[dst:dst + seg] = g[src:src + seg]
        placed += seg
    unit_lo, unit_hi = spec["tandem_unit_bases"]
    copies_lo, copies_hi = spec["tandem_copies"]
    target, placed = int(n * spec["tandem_share"]), 0
    while placed < target:
        unit = int(rng.integers(unit_lo, unit_hi + 1))
        copies = int(rng.integers(copies_lo, copies_hi + 1))
        seg = unit * copies
        dst = int(rng.integers(0, max(n - seg, 1)))
        g[dst:dst + seg] = np.tile(g[dst:dst + unit], copies)
        placed += seg
    return g


def codes_of(ascii_genome: np.ndarray) -> np.ndarray:
    """ASCII bases -> codes 0..3 (A, C, G, T), uint8."""
    return _CODE[ascii_genome]


def spec_digest(spec: dict) -> str:
    """A short digest of a genome spec: the cache's key."""
    text = json.dumps(spec, sort_keys=True).encode()
    return hashlib.sha256(text).hexdigest()[:16]


def cached_genome(spec: dict, cache_dir: str) -> np.ndarray:
    """The spec's ASCII genome, memory-mapped from `cache_dir`, where the
    first call in a checkout writes it (whole, then renamed into place)."""
    path = os.path.join(cache_dir, f"genome-{spec_digest(spec)}.npy")
    if not os.path.exists(path):
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".partial.npy"
        np.save(tmp, make_genome(spec))
        os.replace(tmp, path)
    return np.load(path, mmap_mode="r")
