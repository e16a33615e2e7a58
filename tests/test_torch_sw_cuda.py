"""The CUDA Smith-Waterman kernels on the card (skipped without a GPU).

The kernels (sapling_tpu_torch/csrc/sw.cu) have no CPU mode, so these tests
need a CUDA device; here they skip. They import neither jax nor
sapling_tpu, so they run on a machine without JAX, from the repo root:

    python -m pytest --noconftest tests/test_torch_sw_cuda.py -q

The reference is the plain PyTorch sw_pass (itself held against
sapling_tpu by tests/test_torch_sw.py); every field must be equal.
"""

import numpy as np
import pytest
import torch

from sapling_tpu_torch.ops import sw, sw_cuda
from sapling_tpu_torch.ops.pack import pack_codes
from sapling_tpu_torch.sim.genomes import (simulate_reads, uniform_genome,
                                           write_fastq)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _batch(rng, b, w, r, dev):
    q = rng.integers(0, 5, (b, w)).astype(np.int8)
    ref = rng.integers(0, 5, (b, r)).astype(np.int8)
    for i in range(0, b, 3):           # some high-scoring lanes
        ln = min(w, r - 5)
        ref[i, 5:5 + ln] = q[i, :ln]
    ql = rng.integers(0, w + 1, b).astype(np.int32)
    rl = rng.integers(0, r + 1, b).astype(np.int32)
    ql[:3], rl[2] = (0, 1, w), 0        # qlen 0, 1 and W; rlen 0
    return [torch.from_numpy(a).to(dev) for a in (q, ql, ref, rl)]


# the score-only kernel's strip shapes (G lanes of S rows a pair) change at
# these padded widths: each G from 1 to 32 on both sides of its edge
STRIP_EDGES = (16, 17, 32, 33, 64, 65, 128, 129, 256, 257, 512, 513, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,r", [(700, 100, 128), (300, 31, 7),
                                   (64, 1000, 300), (40, 500, 13_000),
                                   (48, 1024, 200),
                                   # row tiles: two and three of 1,024 rows
                                   (24, 1500, 1600), (6, 2100, 200)]
                         + [(97, w, 60) for w in STRIP_EDGES])
def test_kernel_matches_plain(dev, b, w, r):
    rng = np.random.default_rng(b + w + r)
    q, ql, ref, rl = _batch(rng, b, w, r, dev)
    no_term = torch.full((b,), -1, dtype=torch.int32, device=dev)
    term = sw.sw_pass(q, ql, ref, rl, no_term)["score"].contiguous()
    for tm, kw in ((no_term, dict(pad_to=16)),
                   (no_term, dict(pad_to=8, second_inclusive=True)),
                   (term, dict(pad_to=16)),
                   (no_term, dict(match=3, mismatch=1, gap_open=5,
                                  gap_extend=2, mask_len=7)),
                   (no_term, dict(pad_to=16, score_only=True)),
                   (no_term, dict(pad_to=8, score_only=True)),
                   # a mismatch that scores
                   (no_term, dict(match=1, mismatch=-1, gap_open=2,
                                  gap_extend=1)),
                   (no_term, dict(match=1, mismatch=-1, gap_open=2,
                                  gap_extend=1, score_only=True)),
                   (no_term, dict(match=3, mismatch=1, gap_open=5,
                                  gap_extend=2, score_only=True))):
        before = sum(sw_cuda.LAUNCHES.values())
        got = sw_cuda.sw_pass_cuda(q, ql, ref, rl, tm, **kw)
        torch.cuda.synchronize()
        assert sum(sw_cuda.LAUNCHES.values()) == before + 1
        want = sw.sw_pass(q, ql, ref, rl, tm, **kw)
        for k in want:
            assert torch.equal(got[k], want[k]), (kw, k)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    rng = np.random.default_rng(1)
    q, ql, ref, rl = _batch(rng, 8, 40, 60, dev)
    tm = torch.full((8,), -1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sw_cuda.sw_pass_cuda(q.int(), ql, ref, rl, tm)          # dtype
    with pytest.raises(ValueError):
        sw_cuda.sw_pass_cuda(q, ql.cpu(), ref, rl, tm)          # device
    with pytest.raises(ValueError):
        sw_cuda.sw_pass_cuda(q[:, ::2], ql, ref, rl, tm)        # layout
    with pytest.raises(ValueError):                             # H range
        sw_cuda.sw_pass_cuda(q, ql, ref, rl, tm, match=1 << 25)


@pytest.mark.cuda
def test_full_kernel_past_the_int32_key(dev):
    """Scores past 2^21, where an int32 key H * 1024 + row overflows: the
    full mode's int64-key instantiation equals the plain sw_pass (the
    wrapper refused these inputs before)."""
    rng = np.random.default_rng(4)
    q, ql, ref, rl = _batch(rng, 8, 1100, 1100, dev)
    q[0] = q[0] % 4
    ref[0, :1100] = q[0]
    ql[0], rl[0] = 1100, 1100
    tm = torch.full((8,), -1, dtype=torch.int32, device=dev)
    for kw in (dict(match=1 << 16), dict(match=3000, pad_to=8,
                                         second_inclusive=True)):
        got = sw_cuda.sw_pass_cuda(q, ql, ref, rl, tm, **kw)
        want = sw.sw_pass(q, ql, ref, rl, tm, **kw)
        assert int(want["score"].max()) >= 1 << 21
        for k in want:
            assert torch.equal(got[k], want[k]), (kw, k)


@pytest.mark.cuda
def test_full_kernel_past_the_old_column_cap(dev):
    """R = 60,000 columns, past the 58,112 that the full mode's shared
    memory once held: the column records live in device memory."""
    b, w, r = 4, 40, 60_000
    q, ql, ref, rl = _batch(np.random.default_rng(3), b, w, r, dev)
    rl[:] = torch.tensor([r, r - 7, 0, r // 2], dtype=torch.int32)
    tm = torch.full((b,), -1, dtype=torch.int32, device=dev)
    got = sw_cuda.sw_pass_cuda(q, ql, ref, rl, tm)
    want = sw.sw_pass(q, ql, ref, rl, tm)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_winner_program_on_card_matches_cpu(dev):
    """The aligner's device program (decode, score-only sweep, winner
    selection, winner-row full and reverse passes) on the card == on the
    CPU, for every read that has a winner."""
    rng = np.random.default_rng(2)
    n, w, ne, nr, c = 50_000, 100, 400, 200, 3000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    packed = torch.from_numpy(pack_codes(codes, pad_words=16).astype(np.int64))
    codes_mat = rng.integers(0, 4, (ne, w)).astype(np.uint8)
    for e in range(ne):
        s = int(rng.integers(0, n - w))
        codes_mat[e] = codes[s:s + w]
    cand_rd = np.sort(rng.integers(0, nr, c))
    cand_ei = rng.integers(0, ne, c)
    qlen = np.full(c, w, np.int32)
    lo = rng.integers(0, n - 130, c)
    rlen = np.full(c, w + 4, np.int32)
    args = (cand_ei, qlen, lo, rlen, cand_rd, nr)
    cwin, cf = sw.sw_align_winner_from_genome(
        packed, torch.from_numpy(codes_mat), *args)
    before = dict(sw_cuda.LAUNCHES)
    gwin, gf = sw.sw_align_winner_from_genome(
        packed.to(dev), torch.from_numpy(codes_mat).to(dev), *args)
    assert sw_cuda.LAUNCHES["score_only"] == before["score_only"] + 1
    assert sw_cuda.LAUNCHES["full"] == before["full"] + 2
    np.testing.assert_array_equal(gwin, cwin)
    has = cwin < c
    for k in sw.WINNER_FIELDS:
        np.testing.assert_array_equal(gf[k][has], cf[k][has], err_msg=k)


def long_read_corpus():
    """A 60 kbp genome and one block of reads: eight of 100 bases and one
    of 1,500 (2% substitutions each). tests/test_torch_aligner.py aligns
    the same block on the CPU against sapling_tpu."""
    g = uniform_genome(60_000, seed=88)
    short, _pos, _rc = simulate_reads(g, 8, 100, sub_rate=0.02, seed=9)
    long_, _pos, _rc = simulate_reads(g, 1, 1500, sub_rate=0.02, seed=10)
    return g, list(short[:4]) + [long_[0]] + list(short[4:])


@pytest.mark.cuda
def test_aligner_block_with_a_long_read_matches_cpu(dev, tmp_path):
    """One block holding a 1,500-base read among 100-base reads: every
    candidate is padded to 1,500 rows (two tiles), and the long read's
    winner overflows SSW's byte score and takes the pad-8 full passes. The
    SAM on the card is byte-identical to the port's CPU path."""
    from sapling_tpu_torch.align.aligner import SeedExtendAligner
    from sapling_tpu_torch.config import AlignerConfig, IndexConfig
    from sapling_tpu_torch.index.sapling import SaplingIndex
    from sapling_tpu_torch.io.fasta import write_fasta

    g, reads = long_read_corpus()
    ref_fa, fq = str(tmp_path / "ref.fa"), str(tmp_path / "reads.fq")
    write_fasta(ref_fa, [("chrL", bytes(g))])
    write_fastq(fq, reads)
    idx = SaplingIndex.from_fasta(ref_fa, IndexConfig(k=16), device="cpu")
    cpu_sam, dev_sam = str(tmp_path / "cpu.sam"), str(tmp_path / "dev.sam")
    SeedExtendAligner(idx, AlignerConfig(), device="cpu").align_fastq(
        fq, cpu_sam, cl="align")
    before = dict(sw_cuda.LAUNCHES)
    SeedExtendAligner(idx, AlignerConfig(), device=dev).align_fastq(
        fq, dev_sam, cl="align")
    # the winner rows' two passes and the long read's four pad-8 ones
    assert sw_cuda.LAUNCHES["full"] == before["full"] + 6
    with open(cpu_sam, "rb") as a, open(dev_sam, "rb") as b:
        assert a.read() == b.read()
