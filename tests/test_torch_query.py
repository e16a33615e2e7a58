"""Parity: the PyTorch port's plquery == sapling_tpu's query_positions.

Positions must be bit-identical, -1s included, and so must the member of
a duplicate run that comes back. The genome/k/length grid is
tests/test_query.py's; lengths above k need the general cascade, which the
port does not have yet, and must be refused.
"""

import numpy as np
import pytest

from sapling_tpu.config import IndexConfig
from sapling_tpu.index.sapling import SaplingIndex as JaxIndex
from sapling_tpu.io.fasta import Genome
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.sim.genomes import (benchmark_genome,
                                           gc_biased_genome, repeat_genome,
                                           uniform_genome)


def _queries(seq, num, length, seed):
    """In-genome substrings plus 1/8 random (mostly absent) queries."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, len(seq) - length + 1, num)
    q = seq[pos[:, None] + np.arange(length)]
    rand = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (max(1, num // 8), length))]
    return packops.encode_bases(np.concatenate([q, rand]))


def _pair(seq, k, buckets):
    jidx = JaxIndex.build(Genome(seq=seq, chr_ends=[(len(seq), "sim")]),
                          IndexConfig(k=k, buckets=buckets))
    return jidx, SaplingIndex.from_arrays(jidx, device="cpu")


GRID = [
    (lambda: uniform_genome(800, seed=10), 8, 5, 8),     # L == k
    (lambda: uniform_genome(800, seed=11), 8, 5, 5),     # L < k
    (lambda: uniform_genome(800, seed=12), 8, 5, 20),    # L > k
    (lambda: gc_biased_genome(1500, 0.85, seed=13), 10, 7, 10),
    (lambda: repeat_genome(900, 23, seed=14), 8, 6, 16),  # L > k, repeats
    (lambda: uniform_genome(3000, seed=15), 12, 9, 12),
    # the slice's own shapes: aligner seeds (k=16) and the bench (k=21)
    (lambda: benchmark_genome(30_000, seed=16), 16, 12, 16),
    (lambda: benchmark_genome(30_000, seed=17), 21, 14, 21),
    (lambda: repeat_genome(4000, 37, seed=18), 21, 10, 13),
]


@pytest.mark.parametrize("gen,k,buckets,length", GRID)
def test_plquery_position_parity(gen, k, buckets, length):
    seq = gen()
    jidx, tidx = _pair(seq, k, buckets)
    codes = _queries(seq, 400, length, seed=99)
    if length > k:
        with pytest.raises(NotImplementedError):
            tidx.query_positions(codes)
        return
    want = np.asarray(jidx.query_positions(codes))
    got = tidx.query_positions(codes)
    np.testing.assert_array_equal(got, want)
    assert tidx.verify_hits(codes, got)[:400].all()


def test_count_and_verify_hits_match_jax():
    seq = benchmark_genome(20_000, seed=19)
    jidx, tidx = _pair(seq, 16, 10)
    rng = np.random.default_rng(3)
    ranks = rng.integers(0, len(seq), 3000)
    for a, b in zip(tidx.count_hits(ranks, 32), jidx.count_hits(ranks, 32)):
        np.testing.assert_array_equal(a, b)
    codes = _queries(seq, 500, 16, seed=4)
    pos = rng.integers(-1, len(seq), len(codes))
    pos[:500] = tidx.query_positions(codes[:500])
    np.testing.assert_array_equal(tidx.verify_hits(codes, pos),
                                  jidx.verify_hits(codes, pos))
