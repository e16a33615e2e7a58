"""The port's multi-process FASTQ -> SAM (sapling_tpu_torch.parallel.multihost)
against sapling_tpu's: the shard bounds, single-shard splits, the FASTQ
frame checks, and align_fastq_multihost on 2 spawned gloo CPU ranks,
whose merged SAM is byte-identical to sapling_tpu's single-stream SAM.
The twin of tests/test_multihost.py.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import pytest

from sapling_tpu.align.aligner import SeedExtendAligner
from sapling_tpu.config import AlignerConfig, IndexConfig
from sapling_tpu.index.sapling import SaplingIndex
from sapling_tpu.parallel import multihost as jax_multihost
from sapling_tpu.sim.genomes import simulate_reads, uniform_genome, write_fastq
from sapling_tpu_torch.parallel.multihost import (count_fastq_records,
                                                  shard_bounds, spawn_ranks,
                                                  split_fastq)

from . import torch_dist_worker


def test_shard_bounds_cover_exactly():
    for n in (0, 1, 7, 100, 101):
        for s in (1, 2, 3, 8):
            spans = [shard_bounds(n, s, i) for i in range(s)]
            assert spans == [jax_multihost.shard_bounds(n, s, i)
                             for i in range(s)]
            covered = []
            for lo, hi in spans:
                covered.extend(range(lo, hi))
            assert covered == list(range(n)), (n, s)


@pytest.mark.parametrize("shard", range(4))
def test_split_fastq_single_shard_streaming(tmp_path, shard):
    """shard=s writes ONLY that shard's file, byte-identical to
    sapling_tpu's full split's file; the full split concatenates back to
    the record stream."""
    g = uniform_genome(20_000, seed=3)
    reads, _, _ = simulate_reads(g, 23, 80, sub_rate=0.01, seed=9)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, reads)

    full = jax_multihost.split_fastq(fq, 4, str(tmp_path / "all"))
    only = split_fastq(fq, 4, str(tmp_path / "one"), shard=shard)
    assert sorted(os.listdir(tmp_path / "one")) == [
        os.path.basename(only[shard])]
    assert open(only[shard], "rb").read() == open(full[shard], "rb").read()
    mine = split_fastq(fq, 4, str(tmp_path / "mine"))
    cat = b"".join(open(p, "rb").read() for p in mine)
    assert cat == open(fq, "rb").read()


@pytest.mark.parametrize("bad,line", [(b"x", 5), (b"-", 7)])
def test_count_fastq_records_refuses_a_shifted_frame(tmp_path, bad, line):
    """A record header without '@' or a separator without '+' raises, as
    in sapling_tpu, at the same line."""
    lines = [b"@r0", b"ACGT", b"+", b"IIII", b"@r1", b"ACGT", b"+", b"IIII"]
    lines[line - 1] = bad + lines[line - 1][1:]
    fq = tmp_path / "bad.fq"
    fq.write_bytes(b"\n".join(lines) + b"\n")
    for count in (count_fastq_records, jax_multihost.count_fastq_records):
        with pytest.raises(ValueError, match=f":{line}: malformed FASTQ"):
            count(str(fq))


def test_two_rank_distributed_sam(tmp_path):
    """align_fastq_multihost on 2 spawned ranks: split -> per-shard align
    -> barrier -> rank-0 merge; the merged SAM is byte-identical to
    sapling_tpu's single-stream SAM (which runs here meanwhile)."""
    g = uniform_genome(60_000, seed=13)
    idx = SaplingIndex.build(g, IndexConfig(k=16))
    idx.chr_ends = [(60_000, "chr1")]
    art = str(tmp_path / "idx.stpu.npz")
    idx.save(art)
    reads, _, _ = simulate_reads(g, 40, 100, sub_rate=0.02, seed=5)
    fq = str(tmp_path / "reads.fq")
    write_fastq(fq, reads)
    out = str(tmp_path / "merged.sam")
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn_ranks, torch_dist_worker.align_multihost, 2,
                          f"file://{tmp_path / 'rendezvous'}", "gloo",
                          (art, fq, out, str(tmp_path / "work")), 300)
        single = str(tmp_path / "single.sam")
        SeedExtendAligner(idx, AlignerConfig()).align_fastq(fq, single,
                                                            cl="x")
        assert ranks.result() == [0, 1]
    assert open(out, "rb").read() == open(single, "rb").read()
