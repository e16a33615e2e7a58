"""Parity: the PyTorch port's Smith-Waterman == sapling_tpu's, bit for bit.

The plain PyTorch `sw_pass` is held against `sapling_tpu.ops.sw.sw_pass`
(XLA) and against the Pallas kernel `sw_pass_pallas` in interpret mode, as
tests/test_sw_pallas.py runs it, on every field and every knob; the
higher-level passes (sw_align_ends, sw_align_begins and the aligner's
winner program) against their JAX twins. On the CPU the kernel wrapper
`sw_pass_cuda` takes the plain version; the CUDA kernel itself is checked
on the card by tests/test_torch_sw_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from sapling_tpu.ops import sw as jsw
from sapling_tpu.ops.pack import pack_codes
from sapling_tpu.ops.sw_pallas import sw_pass_pallas
from sapling_tpu_torch.ops import sw, sw_cuda

FIELDS = ("score", "ref_end", "read_end", "score2", "ref_end2")


def _random_batch(rng, b, w, r, related_every=3):
    q = rng.integers(0, 5, (b, w)).astype(np.int8)
    ref = rng.integers(0, 5, (b, r)).astype(np.int8)
    for i in range(0, b, related_every):   # some high-scoring lanes
        ln = min(w, r - 5)
        ref[i, 5:5 + ln] = q[i, :ln]
    ql = rng.integers(5, w + 1, b).astype(np.int32)
    rl = rng.integers(10, r + 1, b).astype(np.int32)
    return q, ql, ref, rl


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_fields(got, want, keys):
    assert set(got) == set(want) == set(keys)
    for k in keys:
        np.testing.assert_array_equal(
            got[k].numpy() if torch.is_tensor(got[k]) else got[k],
            np.asarray(want[k]), err_msg=k)


CASES = {
    "pad16": dict(pad_to=16),
    "pad8_second_inclusive": dict(pad_to=8, second_inclusive=True),
    "score_only": dict(pad_to=16, score_only=True),
    "nondefault_scoring": dict(match=3, mismatch=1, gap_open=5,
                               gap_extend=2, mask_len=7),
    "nondefault_pad8": dict(match=1, mismatch=3, gap_open=4, gap_extend=4,
                            mask_len=3, pad_to=8, second_inclusive=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sw_pass_matches_xla_and_pallas(case):
    kw = CASES[case]
    rng = np.random.default_rng(11 + len(case))
    q, ql, ref, rl = _random_batch(rng, 40, 40, 60)
    term = np.full(40, -1, np.int32)
    keys = ("score",) if kw.get("score_only") else FIELDS
    got = sw.sw_pass(*_t(q, ql, ref, rl, term), **kw)
    _assert_fields(got, jsw.sw_pass(q, ql, ref, rl, term, **kw), keys)
    _assert_fields(got, sw_pass_pallas(q, ql, ref, rl, term, interpret=True,
                                       **kw), keys)
    # the kernel wrapper takes the plain version for CPU tensors
    _assert_fields(sw_cuda.sw_pass_cuda(*_t(q, ql, ref, rl, term), **kw),
                   got, keys)


def test_sw_pass_terminate_matches_xla_and_pallas():
    rng = np.random.default_rng(12)
    q, ql, ref, rl = _random_batch(rng, 32, 24, 36)
    no_term = np.full(32, -1, np.int32)
    term = np.array(jsw.sw_pass(q, ql, ref, rl, no_term)["score"],
                    np.int32)
    term[::5] -= 2                      # some lanes stop early, some never
    got = sw.sw_pass(*_t(q, ql, ref, rl, term))
    _assert_fields(got, jsw.sw_pass(q, ql, ref, rl, term), FIELDS)
    _assert_fields(got, sw_pass_pallas(q, ql, ref, rl, term, interpret=True),
                   FIELDS)


def test_sw_align_ends_matches_jax():
    rng = np.random.default_rng(13)
    q, ql, ref, rl = _random_batch(rng, 30, 100, 140)
    want = jsw.sw_align_ends(q, ql, ref, rl)
    _assert_fields(sw.sw_align_ends(*_t(q, ql, ref, rl)), want, want.keys())


def test_sw_align_ends_overflow_rerun_matches_jax():
    """Scores >= 255 - mismatch take the word kernel's pad-8 fields
    (ssw.c:835-841): long exact matches reach them."""
    rng = np.random.default_rng(21)
    q, ql, ref, rl = _random_batch(rng, 12, 160, 200, related_every=1)
    q[q == 4] = 1                       # no N: exact matches all score
    ref[:, 5:165] = q
    # half the lanes: a 40-base mismatch run keeps them below 255
    ref[::2, 95:135] = (q[::2, 90:130] + 1) % 4
    ql[:] = 160
    rl[:] = 200
    want = jsw.sw_align_ends(q, ql, ref, rl)
    over = np.asarray(want["score"]) + 2 >= 255
    assert over.any() and not over.all()
    _assert_fields(sw.sw_align_ends(*_t(q, ql, ref, rl)), want, want.keys())


def test_sw_align_begins_matches_jax():
    rng = np.random.default_rng(14)
    q, ql, ref, rl = _random_batch(rng, 24, 60, 90)
    fwd = jsw.sw_align_ends(q, ql, ref, rl, forward_only=True)
    want = jsw.sw_align_begins(q, ql, ref, rl, fwd)
    got = sw.sw_align_begins(*_t(q, ql, ref, rl),
                             {k: torch.from_numpy(np.asarray(v))
                              for k, v in fwd.items()})
    _assert_fields(got, want, ("ref_begin", "read_begin"))


def test_winner_from_genome_matches_jax():
    """The aligner's device program: windows decoded from the packed
    genome, score-only sweep, per-read winner, winner-row full and reverse
    passes. Reads without a winner carry no fields (their rows are
    arbitrary in both packages) and are compared by `win` alone."""
    rng = np.random.default_rng(15)
    n, w = 6000, 90
    codes = rng.integers(0, 4, n).astype(np.uint8)
    packed = pack_codes(codes, pad_words=16)
    ne, nr = 24, 14
    codes_mat = rng.integers(0, 5, (ne, w)).astype(np.uint8)
    for e in range(0, ne, 2):          # half the entries come from the genome
        s = int(rng.integers(0, n - w))
        codes_mat[e] = codes[s:s + w]
        codes_mat[e, rng.integers(0, w, 3)] = rng.integers(0, 4, 3)
    lens = rng.integers(50, w + 1, ne)
    for e in range(ne):
        codes_mat[e, lens[e]:] = 0
    cand_rd = np.sort(rng.integers(0, nr - 2, 80))   # 2 reads: no candidate
    cand_ei = rng.integers(0, ne, 80)
    qlen = lens[cand_ei].astype(np.int32)
    lo = rng.integers(0, n - 130, 80)
    rlen = (qlen + rng.integers(0, 6, 80)).astype(np.int32)
    jwin, jf = jsw.sw_align_winner_from_genome(
        packed, codes_mat, cand_ei, qlen, lo, rlen, cand_rd, nr)
    twin, tf = sw.sw_align_winner_from_genome(
        torch.from_numpy(packed.astype(np.int64)),
        torch.from_numpy(codes_mat), cand_ei, qlen, lo, rlen, cand_rd, nr)
    np.testing.assert_array_equal(twin, jwin)
    has = jwin < len(cand_ei)
    assert has.sum() >= nr - 2 and (~has).sum() == 2
    for k in sw.WINNER_FIELDS:
        np.testing.assert_array_equal(tf[k][has], np.asarray(jf[k])[has],
                                      err_msg=k)


def _genome_candidates(rng, n, w, c, exact_len):
    """A packed genome and c candidate rows against it (the winner
    program's inputs but cand_rd): every entry is a read cut from the
    genome, a third of them exact over their first `exact_len` bases, the
    rest with 3 substitutions; windows hold the read's locus, or another
    one."""
    codes = rng.integers(0, 4, n).astype(np.uint8)
    packed = pack_codes(codes, pad_words=16)
    ne = 12
    starts = rng.integers(8, n - w - 8, ne)
    codes_mat = codes[starts[:, None] + np.arange(w)].copy()
    lens = rng.integers(w - 30, w + 1, ne)
    lens[::3] = np.maximum(lens[::3], exact_len)
    for e in range(ne):
        if e % 3:
            codes_mat[e, rng.integers(0, w, 3)] = rng.integers(0, 4, 3)
        codes_mat[e, lens[e]:] = 0
    cand_ei = rng.integers(0, ne, c)
    qlen = lens[cand_ei].astype(np.int32)
    lo = np.where(rng.random(c) < 0.7, starts[cand_ei] - 2,
                  rng.integers(0, n - w - 8, c))
    rlen = (qlen + 4).astype(np.int32)
    return packed, codes_mat, cand_ei, qlen, lo, rlen


def test_winner_from_genome_overflow_matches_jax():
    """The aligner's device program where winners score past a byte
    (candidates of >= 127 exact bases): win and every pad-16 winner field
    equal to JAX's, on the overflowing reads as on the others."""
    rng = np.random.default_rng(23)
    packed, codes_mat, cand_ei, qlen, lo, rlen = _genome_candidates(
        rng, 5000, 150, 120, exact_len=140)
    nr = 40
    cand_rd = np.sort(rng.integers(0, nr, 120))
    jwin, jf = jsw.sw_align_winner_from_genome(
        packed, codes_mat, cand_ei, qlen, lo, rlen, cand_rd, nr)
    twin, tf = sw.sw_align_winner_from_genome(
        torch.from_numpy(packed.astype(np.int64)),
        torch.from_numpy(codes_mat), cand_ei, qlen, lo, rlen, cand_rd, nr)
    np.testing.assert_array_equal(twin, jwin)
    has = jwin < len(cand_ei)
    over = np.asarray(jf["score"])[has] + 2 >= 255
    assert over.any() and not over.all()
    for k in sw.WINNER_FIELDS:
        np.testing.assert_array_equal(tf[k][has], np.asarray(jf[k])[has],
                                      err_msg=k)
