"""Parity: the PyTorch port's plquery == sapling_tpu's query_positions.

Positions must be bit-identical, -1s included, and so must the member of
a duplicate run that comes back. The genome/k/length grid is
tests/test_query.py's, on indexes with and without the per-rank prefix
arrays (fast3, prefix64 and packed-genome probes), plus the reference's
length sweep. tests/test_torch_query_variants.py holds the options.
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


def _pair(seq, k, buckets, **cfg):
    jidx = JaxIndex.build(Genome(seq=seq, chr_ends=[(len(seq), "sim")]),
                          IndexConfig(k=k, buckets=buckets, **cfg))
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
    want = np.asarray(jidx.query_positions(codes))
    got = tidx.query_positions(codes)
    np.testing.assert_array_equal(got, want)
    assert tidx.verify_hits(codes, got)[:400].all()


@pytest.mark.parametrize("gen,k,buckets,length", GRID)
def test_plquery_parity_without_prefix(gen, k, buckets, length):
    """The same grid on indexes built without prefix64/prefix3 on both
    sides: every probe reads the packed genome."""
    seq = gen()
    jidx, tidx = _pair(seq, k, buckets, prefix_lookup=False)
    assert tidx.prefix64 is None and tidx.prefix3 is None
    codes = _queries(seq, 400, length, seed=99)
    want = np.asarray(jidx.query_positions(codes))
    got = tidx.query_positions(codes)
    np.testing.assert_array_equal(got, want)
    assert tidx.verify_hits(codes, got)[:400].all()


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_length_sweep_parity(prefix):
    """The reference's experiment sweep k-10 ... k+80
    (tools/sapling_example.py, tests/test_query.py) on one index."""
    seq = repeat_genome(4000, 37, seed=40)
    k = 12
    jidx, tidx = _pair(seq, k, 8, prefix_lookup=prefix)
    for length in (k - 10, k, k + 10, k + 20, k + 30, k + 80):
        codes = _queries(seq, 96, length, seed=41 + length)
        want = np.asarray(jidx.query_positions(codes))
        got = tidx.query_positions(codes)
        np.testing.assert_array_equal(got, want, err_msg=f"L={length}")
        assert tidx.verify_hits(codes, got)[:96].all()
