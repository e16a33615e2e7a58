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
                                   (48, 1024, 200)]
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
    wide = torch.zeros((8, 1025), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        sw_cuda.sw_pass_cuda(wide, ql, ref, rl, tm)             # W > 1024


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
