"""The score-only SW kernel's schedule, emulated in numpy on the CPU.

`sw_kernel<G, S, false>` in sapling_tpu_torch/csrc/sw.cu runs on the card
only. Its decomposition is emulated here step for step: a group of G
lanes scores one pair, lane g owns the S query rows [g*S, g*S + S) in
registers and computes column s - g at step s; at the end of a step it
hands its bottom row's H, the F into the next lane's first row and the ref
base of its column to lane g + 1 (`__shfl_up_sync(..., width=G)`), and
lane g + 1 keeps the H as the diagonal input of its next column. Only lane
0 reads the ref. F is the plain recurrence F[j] = max(F[j-1] - gapE,
H[j-1] - gapO) with F into row 0 at -2^30; a lane outside [0, rlen) in its
column skips the update, and only real cells (row < qlen, column < rlen)
are counted. The steps run in pairs. `_shape` is the kernel launcher's
choice of (G, S).

It mirrors the schedule, not the kernel's code: it masks each cell with
np.where where the kernel skips a lane's whole column, takes the running
max every step where the kernel folds two columns into one 3-way max,
computes H in one pass where the kernel runs the F-free part of a column
and then the F chain, and reads lane 0's ref base in its own step where
the kernel loads it a step ahead. The kernel's code itself is held against
sw_pass on the CPU by tests/test_torch_sw_cu_on_cpu.py, and on the card by
tests/test_torch_sw_cuda.py.

The emulation must equal both the port's plain sw_pass(score_only=True)
and sapling_tpu's (XLA) exactly, at every qlen and rlen boundary of the
strips, pad 8 and 16, non-default scoring and W up to 1024.
"""

import numpy as np
import pytest
import torch

from sapling_tpu.ops import sw as jsw
from sapling_tpu_torch.ops import sw

NEG = -(1 << 30)
NO_REF = 1000        # an N (or any code >= 4) in the ref: matches nothing
NO_QUERY = 2000      # query code of a row past qlen (never counted)


def _shape(w: int, pad_to: int) -> tuple[int, int]:
    """(G, S) as sw_pass_launch picks them: G the smallest power of two
    (at most 32) with G * 16 >= the padded rows, S the rows a lane then
    needs, rounded up to even."""
    rows = -(-w // pad_to) * pad_to
    g = 1
    while g < 32 and g * 16 < rows:
        g *= 2
    s = max(-(-rows // g), 1)
    return g, s + (s & 1)


def emulate(q, qlen, ref, rlen, *, G, S, pad_to=16, match=2, mismatch=2,
            gap_open=3, gap_extend=1):
    """The kernel's schedule over int64 numpy arrays; returns int32 [B]."""
    b, w = q.shape
    r = ref.shape[1]
    wpad = -(-w // pad_to) * pad_to
    assert G * S >= wpad
    nrows = np.clip(qlen, 0, wpad)                     # real rows
    ncol = np.clip(rlen, 0, r)                         # real columns
    lanes = np.arange(G)
    t_idx = np.arange(S)
    nvalid = np.clip(nrows[:, None] - lanes[None, :] * S, 0, S)   # [B, G]
    j = lanes[:, None] * S + t_idx[None, :]                        # [G, S]
    qv = np.where(j < w, q.astype(np.int64)[:, np.minimum(j, w - 1)], 0)
    qv = np.where(t_idx[None, None, :] < nvalid[:, :, None], qv, NO_QUERY)

    h = np.zeros((b, G, S), np.int64)
    e = np.full((b, G, S), NEG, np.int64)
    hb = np.zeros((b, G, S), np.int64)
    h_in = np.zeros((b, G), np.int64)        # received: H above, this col
    f_in = np.full((b, G), NEG, np.int64)    # received: F into row 0
    rb_in = np.full((b, G), NO_REF, np.int64)    # received: ref base
    diag_top = np.zeros((b, G), np.int64)    # H above, previous column
    nstep = int(np.max(np.where(ncol > 0, ncol + G - 1, 0), initial=0))
    nstep += nstep & 1                       # two steps a trip

    def shfl_up(x):               # lane g gets lane g-1's; lane 0 its own
        return np.concatenate([x[:, :1], x[:, :-1]], axis=1)

    for s in range(nstep):
        c = s - lanes                                              # [G]
        # lane 0 reads the ref; the diagonal into row 0 is 0, F is -2^30
        rb0 = ref.astype(np.int64)[:, min(s, r - 1)]
        rb0 = np.where((s < ncol) & (rb0 < 4), rb0, NO_REF)
        rb = rb_in.copy()
        rb[:, 0] = rb0
        f = f_in.copy()
        f[:, 0] = NEG
        diag = diag_top.copy()
        diag[:, 0] = 0
        diag_top = h_in                       # the next column's diagonal
        act = (c[None, :] >= 0) & (c[None, :] < ncol[:, None])     # [B, G]
        for t in range(S):
            sub = np.where(qv[:, :, t] == rb, match, -mismatch)
            hv = np.maximum(np.maximum(diag + sub, e[:, :, t]),
                            np.maximum(f, 0))
            diag = h[:, :, t].copy()
            te = hv - gap_open
            f = np.where(act, np.maximum(f - gap_extend, te), f)
            e[:, :, t] = np.where(act, np.maximum(e[:, :, t] - gap_extend,
                                                  te), e[:, :, t])
            hb[:, :, t] = np.where(act, np.maximum(hb[:, :, t], hv),
                                   hb[:, :, t])
            h[:, :, t] = np.where(act, hv, h[:, :, t])
        h_in, f_in, rb_in = shfl_up(h[:, :, S - 1]), shfl_up(f), shfl_up(rb)

    counted = np.where(t_idx[None, None, :] < nvalid[:, :, None], hb, 0)
    return counted.max(axis=(1, 2), initial=0).astype(np.int32)


def _batch(rng, w, r, g, s):
    """Every boundary qlen against every boundary rlen, then ragged
    random pairs; every third pair's ref holds its query."""
    qls = sorted({0, 1, s - 1, s, s + 1, g * s, w})
    rls = sorted({0, 1, max(g - 1, 0), r})
    grid = [(a, c) for a in qls for c in rls]
    n = len(grid) + 24
    q = rng.integers(0, 5, (n, w)).astype(np.int8)
    ref = rng.integers(0, 5, (n, r)).astype(np.int8)
    for i in range(0, n, 3):
        ln = min(w, r - 2)
        if ln > 0:
            ref[i, 2:2 + ln] = q[i, :ln]
    ql = rng.integers(0, w + 1, n).astype(np.int32)
    rl = rng.integers(0, r + 1, n).astype(np.int32)
    ql[:len(grid)] = [a for a, _ in grid]
    rl[:len(grid)] = [c for _, c in grid]
    return q, ql, ref, rl


SCORING = {"default": {},
           "nondefault": dict(match=3, mismatch=1, gap_open=5, gap_extend=2),
           # a mismatch that scores, a gap that pays
           "negative": dict(match=1, mismatch=-1, gap_open=2, gap_extend=1),
           "negative_gap": dict(match=2, mismatch=1, gap_open=1,
                                gap_extend=-1)}

# (W, R, pad_to, scoring): the aligner's shape in both pads, every G from
# 1 to 32 and both sides of a G boundary, W = 1024 at a small batch
CASES = [(100, 128, 16, "default"), (100, 128, 8, "default"),
         (100, 128, 16, "nondefault"), (100, 128, 8, "nondefault"),
         (7, 30, 1, "default"), (16, 19, 8, "default"),
         (17, 21, 8, "nondefault"), (33, 40, 8, "default"),
         (65, 9, 16, "default"), (200, 50, 16, "nondefault"),
         (513, 20, 8, "default"), (1024, 24, 16, "default"),
         (100, 128, 16, "negative"), (33, 40, 8, "negative_gap")]


@pytest.mark.parametrize("w,r,pad_to,scoring", CASES)
def test_schedule_matches_both_sw_passes(w, r, pad_to, scoring):
    kw = SCORING[scoring]
    g, s = _shape(w, pad_to)
    rng = np.random.default_rng(w * 1000 + r + pad_to)
    q, ql, ref, rl = _batch(rng, w, r, g, s)
    got = emulate(q, ql, ref, rl, G=g, S=s, pad_to=pad_to, **kw)

    term = np.full(len(ql), -1, np.int32)
    port = sw.sw_pass(*map(torch.from_numpy, (q, ql, ref, rl, term)),
                      pad_to=pad_to, score_only=True, **kw)["score"].numpy()
    xla = np.asarray(jsw.sw_pass(q, ql, ref, rl, term, pad_to=pad_to,
                                 score_only=True, **kw)["score"])
    np.testing.assert_array_equal(got, port)
    np.testing.assert_array_equal(got, xla)
    assert got.max() > 0                # some pair aligned


@pytest.mark.parametrize("pad_to", [8, 16])
def test_pad_rows_do_not_change_the_score(pad_to):
    """The kernel computes real rows only: the same pairs under pad 8 and
    pad 16 give the same score, and qlen past W (rows of code 0 up to the
    padded width) is counted as the plain version counts it."""
    w, r = 100, 128
    rng = np.random.default_rng(pad_to)
    q, ql, ref, rl = _batch(rng, w, r, 8, 14)
    ql[:4] = [101, 104, 112, 200]          # past W: up to the padded rows
    want = sw.sw_pass(*map(torch.from_numpy,
                           (q, ql, ref, rl, np.full(len(ql), -1, np.int32))),
                      pad_to=pad_to, score_only=True)["score"].numpy()
    g, s = _shape(w, pad_to)
    np.testing.assert_array_equal(
        emulate(q, ql, ref, rl, G=g, S=s, pad_to=pad_to), want)
    # a wider strip layout than the launcher's gives the same scores
    np.testing.assert_array_equal(
        emulate(q, ql, ref, rl, G=16, S=8, pad_to=pad_to), want)
    # and with qlen <= W the two pads agree
    keep = ql <= w
    other = 24 - pad_to
    np.testing.assert_array_equal(
        emulate(q[keep], ql[keep], ref[keep], rl[keep],
                G=_shape(w, other)[0], S=_shape(w, other)[1], pad_to=other),
        want[keep])


def test_launcher_shapes():
    """The (G, S) table at the aligner's widths and at the edges."""
    assert _shape(100, 16) == (8, 14)
    assert _shape(100, 8) == (8, 14)
    assert _shape(16, 8) == (1, 16)
    assert _shape(17, 8) == (2, 12)
    assert _shape(1024, 16) == (32, 32)
    assert _shape(513, 8) == (32, 18)
    for w in range(1, 1025):
        for p in (1, 8, 16):
            rows = -(-w // p) * p
            if rows > 1024:
                continue
            g, s = _shape(w, p)
            assert g * s >= rows and s % 2 == 0 and s <= 32 and g <= 32
            assert g == 1 or g * 8 < rows or g == 32
