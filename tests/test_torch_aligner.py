"""End to end: the PyTorch port's FASTQ -> SAM == sapling_tpu's, byte for byte.

The four corpora of tests/test_aligner.py (two chromosomes with 2%
substitutions; indels; a tandem repeat with over-maxHits seeds and reads
at the genome's end; mixed read lengths through small pipelined blocks)
are aligned by both packages on the CPU, each from the same FASTA and the
same cached index artifacts. Every SAM line must be identical; the @PG
line is compared as tests/test_aligner.py does (it echoes the command
line).
"""

import os

import numpy as np
import pytest

from sapling_tpu.align.aligner import SeedExtendAligner as JaxAligner
from sapling_tpu.config import AlignerConfig as JaxAlignerConfig
from sapling_tpu.config import IndexConfig as JaxIndexConfig
from sapling_tpu.index.sapling import SaplingIndex as JaxIndex
from sapling_tpu_torch.align.aligner import SeedExtendAligner
from sapling_tpu_torch.config import AlignerConfig, IndexConfig
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.io.fasta import write_fasta
from sapling_tpu_torch.sim.genomes import (simulate_reads,
                                           simulate_reads_indel,
                                           uniform_genome, write_fastq)

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = {65: 84, 67: 71, 71: 67, 84: 65}


def _mutate(rng, r, rc_prob=0.5):
    mut = rng.random(len(r)) < 0.02
    r[mut] = _BASES[rng.integers(0, 4, mut.sum())]
    if rng.random() < rc_prob:
        r = np.array([_COMP[int(b)] for b in r[::-1]], np.uint8)
    return r


def corpus_fixed(d):
    g = uniform_genome(120_000, seed=31)
    chroms = [("chr1", g[:70_000]), ("chr2", g[70_000:])]
    reads, _pos, _rc = simulate_reads(g, 120, 100, sub_rate=0.02, seed=8)
    return chroms, reads, {}


def corpus_indel(d):
    g = uniform_genome(90_000, seed=77)
    reads, _pos, _rc = simulate_reads_indel(
        g, 80, 100, sub_rate=0.02, indel_rate=0.02, seed=12)
    return [("chrI", g)], np.stack(reads), {}


def corpus_repeat(d):
    rng = np.random.default_rng(2024)
    unit = uniform_genome(180, seed=5)
    g = np.concatenate([uniform_genome(25_000, seed=61), np.tile(unit, 70),
                        uniform_genome(25_000, seed=62)])
    n = len(g)
    starts = np.concatenate([
        rng.integers(24_000, 26_000, 40),       # span unique/repeat edge
        rng.integers(27_000, 35_000, 40),       # deep inside the repeat
        rng.integers(n - 140, n - 100, 10),     # at the genome end
        rng.integers(0, n - 100, 30),
    ])
    reads = [_mutate(rng, g[s:s + 100].copy()) for s in starts]
    return [("chrR", g)], np.stack(reads), {}


def corpus_mixed(d):
    rng = np.random.default_rng(404)
    g = uniform_genome(150_000, seed=19)
    reads = []
    for length in rng.integers(60, 151, 150):
        s = int(rng.integers(0, len(g) - length))
        reads.append(_mutate(rng, g[s:s + length].copy()))
    return ([("chrM", g[:90_000]), ("chrN", g[90_000:])], reads,
            dict(block=64, workers=2))


def corpus_long_read(d):
    """One block with a 1,500-base read among 100-base reads (the card's
    twin is tests/test_torch_sw_cuda.py long_read_corpus): every candidate
    is padded to 1,500 query rows, and the long read's score overflows
    SSW's byte kernel, so its winner takes the pad-8 passes."""
    g = uniform_genome(60_000, seed=88)
    short, _pos, _rc = simulate_reads(g, 8, 100, sub_rate=0.02, seed=9)
    long_, _pos, _rc = simulate_reads(g, 1, 1500, sub_rate=0.02, seed=10)
    return [("chrL", g)], list(short[:4]) + [long_[0]] + list(short[4:]), {}


def _sam_lines_both(make, d, **cfg):
    """(port SAM lines, JAX SAM lines, number of reads) for one corpus,
    each package aligning from the same FASTA and cached artifacts, its
    index built with IndexConfig(k=16, **cfg)."""
    chroms, reads, run_kw = make(d)
    ref_fa = os.path.join(d, "ref.fa")
    write_fasta(ref_fa, [(nm, bytes(s)) for nm, s in chroms])
    fq = os.path.join(d, "reads.fq")
    write_fastq(fq, reads)
    jax_sam = os.path.join(d, "jax.sam")
    our_sam = os.path.join(d, "torch.sam")
    jidx = JaxIndex.from_fasta(ref_fa, JaxIndexConfig(k=16, **cfg))
    JaxAligner(jidx, JaxAlignerConfig()).align_fastq(
        fq, jax_sam, cl=f"align {fq} {ref_fa} {jax_sam}", **run_kw)
    idx = SaplingIndex.from_fasta(ref_fa, IndexConfig(k=16, **cfg),
                                  device="cpu")
    SeedExtendAligner(idx, AlignerConfig(), device="cpu").align_fastq(
        fq, our_sam, cl=f"align {fq} {ref_fa} {our_sam}", **run_kw)
    with open(jax_sam) as f:
        want = f.read().splitlines()
    with open(our_sam) as f:
        got = f.read().splitlines()
    return got, want, len(reads)


def _assert_same_sam(got, want, n_reads):
    assert len(got) == len(want)
    diffs = [(i, a, b) for i, (a, b) in enumerate(zip(got, want))
             if a != b and not a.startswith("@PG")]
    assert not diffs, f"{len(diffs)} differing lines; first: {diffs[0]}"
    assert sum(ln.startswith("@PG") for ln in got) == 1
    records = [ln.split("\t") for ln in got if not ln.startswith("@")]
    assert len(records) == n_reads
    assert sum(r[1] != "4" for r in records) >= 0.9 * n_reads


@pytest.mark.parametrize("make", [corpus_fixed, corpus_indel, corpus_repeat,
                                  corpus_mixed, corpus_long_read],
                         ids=["fixed", "indel", "repeat_heavy",
                              "mixed_length", "long_read"])
def test_sam_bytes_match_jax(make, tmp_path):
    _assert_same_sam(*_sam_lines_both(make, str(tmp_path)))


def test_sam_bytes_match_jax_without_prefix(tmp_path):
    """An index without prefix64/prefix3 (as every index above 1.5 Gbp):
    the seeds take the general path over the packed genome."""
    _assert_same_sam(*_sam_lines_both(corpus_repeat, str(tmp_path),
                                      prefix_lookup=False))


def test_cli_writes_the_same_sam_as_the_api(tmp_path):
    """python -m sapling_tpu_torch.tools.align: same arguments as
    tools/align.py plus device=; output equals the API's."""
    from sapling_tpu_torch.tools.align import main

    d = str(tmp_path)
    chroms, reads, _ = corpus_fixed(d)
    ref_fa = os.path.join(d, "ref.fa")
    write_fasta(ref_fa, [(nm, bytes(s)) for nm, s in chroms])
    fq = os.path.join(d, "reads.fq")
    write_fastq(fq, reads)
    cli_sam = os.path.join(d, "cli.sam")
    argv = ["align", fq, ref_fa, cli_sam, "max_hits=32", "device=cpu"]
    assert main(argv) == 0
    api_sam = os.path.join(d, "api.sam")
    idx = SaplingIndex.load(ref_fa + "_k16_b-1.stpu.npz", device="cpu")
    SeedExtendAligner(idx, AlignerConfig(), device="cpu").align_fastq(
        fq, api_sam, cl=" ".join(argv))
    with open(cli_sam, "rb") as a, open(api_sam, "rb") as b:
        assert a.read() == b.read()
