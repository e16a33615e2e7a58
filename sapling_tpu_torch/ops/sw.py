"""Batched affine-gap Smith-Waterman scoring on PyTorch tensors.

Replacement for the reference's striped Smith-Waterman SSE2 kernels
(reference: src/ssw.c:192-380 byte pass, :406-580 word pass): B independent
(query, ref-window) pairs are scored at once, sweeping reference columns.

The only sequential hazard in a column-major sweep is the vertical gap
recurrence F[j] = max(F[j-1]-gapE, H[j-1]-gapO) (H depends on F in the
same column). Because gapO >= gapE, substituting H = max(H_nof, F) gives
F[j] = max(F[j-1]-gapE, H_nof[j-1]-gapO), which is a decayed running max:
F[j] + gapE*j = cummax(H_nof[j-1] - gapO + gapE*j) — ONE cumulative max
per column instead of a data-dependent fixup loop.

Parity notes vs ssw.c (the same as `sapling_tpu.ops.sw`, whose outputs
these are bit-identical to):
  * score1 is exact int32 (the byte kernel's 255-overflow -> word-kernel
    rerun, ssw.c:835-841, always converges to the exact score).
  * ref_end = EARLIEST column attaining the global max; read_end =
    SMALLEST row attaining it in that column.
  * score2/ref_end2 = the best column max outside +/-mask_len of ref_end,
    earliest column on ties.
  * SSE pad rows: the striped kernels round the query up to a multiple of
    16 (byte) / 8 (word) rows whose substitution score is 0. Those rows
    leak into the per-column maxima (score2, and the reverse pass's
    terminate test) but never into the global max; `pad_to` reproduces
    this exactly.
  * terminate: the reverse pass stops at the first column whose column
    max equals the forward score, after updating the best. -1 disables.

`sw_pass` here is the plain PyTorch version. Every pass of the functions
below goes through `ops.sw_cuda.sw_pass_cuda`, which runs the hand-written
CUDA kernel for tensors on the card and this plain version for tensors on
the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .sw_cuda import sw_pass_cuda

NEG = -(1 << 30)
_I32_MAX = int(np.iinfo(np.int32).max)

# row order of the per-read winner fields
WINNER_FIELDS = ("score", "ref_end", "read_end", "score2", "ref_end2",
                 "ref_begin", "read_begin")


def sw_pass(query, qlen, ref, rlen, terminate, *, match: int = 2,
            mismatch: int = 2, gap_open: int = 3, gap_extend: int = 1,
            mask_len: int = 15, pad_to: int = 16,
            second_inclusive: bool = False, score_only: bool = False):
    """One SW scoring pass over B candidate pairs (plain PyTorch).

    query: integer [B, W] base codes 0..4 (4 = N, mismatches everything)
    qlen:  int [B] true query lengths (rows beyond are dead)
    ref:   integer [B, R] base codes
    rlen:  int [B] true ref-window lengths (columns beyond are skipped)
    terminate: int [B]; stop updating a lane after a column max equals
               this value (-1 = never). Ignored when score_only.

    Returns a dict of int32 [B] tensors: score, ref_end, read_end, score2,
    ref_end2 (score only, when score_only). ref_end = -1 when nothing
    scored > 0 (unaligned lane).
    """
    if gap_open < gap_extend:
        raise ValueError("decayed-max F factorization requires gapO >= gapE")
    dev = query.device
    i32 = torch.int32
    b, w0 = query.shape
    # room for every lane's SSE pad rows: ceil(qlen/pad_to)*pad_to <= w
    w = -(-w0 // pad_to) * pad_to
    q = torch.zeros((b, w), dtype=i32, device=dev)
    q[:, :w0] = query
    r = ref.shape[1]
    refi = ref.to(i32)
    qlen = qlen.to(i32)
    rlen = rlen.to(i32)
    terminate = terminate.to(i32)

    jidx = torch.arange(w, dtype=i32, device=dev)[None, :]     # [1, W]
    valid_row = jidx < qlen[:, None]                           # real rows
    padlen = torch.div(qlen + pad_to - 1, pad_to,
                       rounding_mode="floor") * pad_to
    live_row = jidx < padlen[:, None]                          # + SSE pads
    ge_j = gap_extend * jidx                                   # decay offsets
    neg_col = torch.full((b, 1), NEG, dtype=i32, device=dev)
    zero_col = torch.zeros((b, 1), dtype=i32, device=dev)

    def column_h(h, e, i):
        rbase = refi[:, i : i + 1]
        sub = torch.where((q == rbase) & (q < 4), match, -mismatch)
        sub = torch.where(valid_row, sub, 0)
        diag = torch.cat([zero_col, h[:, :-1]], dim=1)         # H[j-1] prev col
        h_nof = torch.clamp(torch.maximum(diag + sub, e), min=0)
        h_nof = torch.where(live_row, h_nof, 0)
        # F via decayed running max (see module docstring)
        a = torch.cat([neg_col, h_nof[:, :-1] - gap_open], dim=1)
        f = torch.cummax(a + ge_j, dim=1).values - ge_j
        h_new = torch.where(live_row, torch.maximum(h_nof, f), 0)
        e_new = torch.where(live_row,
                            torch.maximum(e - gap_extend, h_new - gap_open),
                            NEG)
        return h_new.to(i32), e_new.to(i32)

    h = torch.zeros((b, w), dtype=i32, device=dev)
    e = torch.full((b, w), NEG, dtype=i32, device=dev)
    if score_only:
        # per-cell running max; the value is bit-identical to the full
        # pass's score (same recurrence, same masks)
        best_h = torch.zeros((b, w), dtype=i32, device=dev)
        for i in range(r):
            h_new, e_new = column_h(h, e, i)
            col_ok = (i < rlen)[:, None]
            best_h = torch.where(col_ok, torch.maximum(best_h, h_new), best_h)
            h = torch.where(col_ok, h_new, h)
            e = torch.where(col_ok, e_new, e)
        score = torch.where(valid_row, best_h, 0).amax(dim=1)
        return {"score": score.to(i32)}

    best = torch.zeros(b, dtype=i32, device=dev)
    best_ref = torch.full((b,), -1, dtype=i32, device=dev)
    best_col = torch.zeros((b, w), dtype=i32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    colmax = torch.zeros((b, r), dtype=i32, device=dev)
    for i in range(r):
        h_new, e_new = column_h(h, e, i)
        col_ok = (i < rlen) & ~done
        colmax_real = torch.where(valid_row, h_new, -1).amax(dim=1)
        colmax_pad = torch.where(live_row, h_new, -1).amax(dim=1)
        upd = col_ok & (colmax_real > best)
        best = torch.where(upd, colmax_real, best)
        best_ref = torch.where(upd, i, best_ref)
        best_col = torch.where(upd[:, None], h_new, best_col)
        done = done | (col_ok & (colmax_pad == terminate))
        # freeze H/E on finished lanes (the C loop broke out)
        h = torch.where(col_ok[:, None], h_new, h)
        e = torch.where(col_ok[:, None], e_new, e)
        colmax[:, i] = torch.where(col_ok, colmax_pad, 0)

    big = 1 << 30
    # read_end: smallest real row attaining the max in the best column
    hit = valid_row & (best_col == best[:, None])
    first_hit = torch.where(hit, jidx, big).amin(dim=1)
    read_end = torch.where(first_hit < big, first_hit, qlen - 1)

    # second best: best column max outside [ref_end-mask, ref_end+mask]
    iidx = torch.arange(r, dtype=i32, device=dev)[None, :]
    lo_edge = torch.clamp(best_ref - mask_len, min=0)[:, None]
    hi_edge = torch.minimum(best_ref + mask_len, rlen)[:, None]
    # the reference's 8-bit kernel excludes the right edge column
    # (ssw.c:366: i = edge + 1), the 16-bit kernel includes it
    # (ssw.c:571: i = edge) — second_inclusive selects the word behavior.
    right_ok = (iidx >= hi_edge) if second_inclusive else (iidx > hi_edge)
    eligible = ((iidx < lo_edge) | right_ok) & (iidx < rlen[:, None])
    masked = torch.where(eligible, colmax, 0)
    score2 = masked.amax(dim=1) if r else torch.zeros_like(best)
    first2 = torch.where(masked == score2[:, None], iidx, big).amin(dim=1) \
        if r else torch.zeros_like(best)
    ref_end2 = torch.where(score2 > 0, first2, 0)
    return {
        "score": best,
        "ref_end": best_ref,
        "read_end": read_end.to(i32),
        "score2": score2.to(i32),
        "ref_end2": ref_end2.to(i32),
    }


def _codes(t: torch.Tensor) -> torch.Tensor:
    """Base codes as the contiguous int8 the SW kernel reads."""
    return t.to(torch.int8).contiguous()


def _lens(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _reverse_prefixes(query, ref, q_end, r_end):
    """Reversed query prefixes [0..q_end] and ref prefixes [0..r_end] of
    each row (ssw.c:860-875): out[j] = in[max(end - j, 0)]."""
    jr = torch.arange(query.shape[1], device=query.device)[None, :]
    ir = torch.arange(ref.shape[1], device=ref.device)[None, :]
    q_rev = torch.gather(query, 1, torch.clamp(q_end[:, None] - jr, min=0))
    r_rev = torch.gather(ref, 1, torch.clamp(r_end[:, None] - ir, min=0))
    return q_rev, r_rev


def _ssw_pass(query, qlen, ref, rlen, terminate, score=None, **kw):
    """sw_pass_cuda as ssw_align splits it between its byte and word
    kernels (ssw.c:835-841): pad 16 on every lane, then pad 8 with the
    word kernel's inclusive second-best edge on the lanes whose score
    overflows a byte (score + mismatch >= 255), whose fields the rerun
    replaces. `score` is the forward score that decides the split (a
    reverse pass's); without it, this pass's own. kw: match, mismatch,
    gap_open, gap_extend, mask_len."""
    out = sw_pass_cuda(query, qlen, ref, rlen, terminate, pad_to=16, **kw)
    s = out["score"] if score is None else score
    rows = torch.nonzero(s + kw["mismatch"] >= 255).squeeze(1)
    if rows.numel():
        sub = sw_pass_cuda(query[rows], qlen[rows], ref[rows], rlen[rows],
                           terminate[rows], pad_to=8, second_inclusive=True,
                           **kw)
        out = {k: v.index_put((rows,), sub[k]) for k, v in out.items()}
    return out


def sw_align_ends(query, qlen, ref, rlen, *, match=2, mismatch=2,
                  gap_open=3, gap_extend=1, mask_len=15):
    """Forward + reverse passes: full ssw_align endpoint semantics
    (reference: src/ssw.c:810-901) for a batch of tensors on one device.

    Returns a dict of int32 [B] tensors: score, score2, ref_end2,
    ref_begin, ref_end, read_begin, read_end (genome-window coordinates).

    The byte/word kernel split (ssw.c:835-841) changes only the SSE pad
    multiple: byte pads to 16 rows, word to 8. A lane reruns in word mode
    when its byte score saturates (score + bias >= 255, bias = mismatch).
    """
    query, ref = _codes(query), _codes(ref)
    qlen, rlen = _lens(qlen), _lens(rlen)
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, mask_len=mask_len)
    fwd = _ssw_pass(query, qlen, ref, rlen, torch.full_like(qlen, -1), **kw)
    out = dict(fwd)
    out.update(sw_align_begins(query, qlen, ref, rlen, fwd, **kw))
    return out


def _decode_windows(packed, codes_mat, cand_ei, qlen, w0, lo_mod, rlen,
                    rmax):
    """[C, WMAX] query rows (codes_mat gather, tails zeroed) and [C, rmax]
    ref windows decoded from the big-endian 2-bit packed genome (ops/pack.py
    pack_codes layout: base p lives in word p>>4 at bit 30-2*(p&15)),
    held as int64 words. rmax is a multiple of 16. Returns int8 codes."""
    dev = packed.device
    q = codes_mat[cand_ei]                                  # [C, WMAX]
    col = torch.arange(q.shape[1], device=dev)[None, :]
    q = torch.where(col < qlen[:, None], q, 0)

    # the in-word offset lo_mod is uniform per row, so the window's words
    # realign with one funnel shift (w'_j = wv_j << 2*m | wv_{j+1} >>
    # 32-2*m) and every base then decodes at a static stride
    na = rmax // 16
    widx = torch.clamp(w0[:, None] + torch.arange(na + 1, device=dev)[None, :],
                       max=packed.shape[0] - 1)
    wv = packed[widx]                                       # [C, na+1]
    sh = (lo_mod * 2)[:, None]                              # [C, 1]
    hi_part = torch.where(sh == 0, 0, wv[:, 1:] >> (32 - sh))
    al = ((wv[:, :na] << sh) | hi_part) & 0xFFFFFFFF        # aligned words
    shifts = torch.arange(30, -2, -2, device=dev)[None, None, :]
    r = ((al[:, :, None] >> shifts) & 3).reshape(al.shape[0], rmax)
    jcol = torch.arange(rmax, device=dev)[None, :]
    r = torch.where(jcol < rlen[:, None], r, 0)
    return _codes(q), _codes(r)


def sw_align_winner_from_genome(packed, codes_mat, cand_ei, qlen, lo, rlen,
                                cand_rd, nr, *, match=2, mismatch=2,
                                gap_open=3, gap_extend=1, mask_len=15):
    """Score every candidate window, select each read's winner, and run
    the full forward and the reverse (begin-position) pass on the winner
    rows only, all on packed's device.

    packed: int64 [n_words + pad] packed genome words (device);
    codes_mat: uint8 [NE, WMAX] per-entry read codes (device);
    cand_ei / qlen / lo / rlen / cand_rd: numpy [C] per-candidate entry
    row, read length, genome window start, window length and read id
    (ascending: the reference's walk order); nr: reads in the block.

    The winner of a read is the first candidate row attaining the read's
    max score — the reference's strict-greater serial walk. Selection uses
    the 16-pad score, exact in both SSW kernel modes; overflowing winners
    (score+mismatch >= 255) need their pad-8 fields recomputed by the
    caller. Returns (win, fields) as numpy: win[read] is the winning row,
    or int32 max when the read has none; fields maps WINNER_FIELDS to
    int32 [nr] arrays.
    """
    dev = packed.device
    c = int(len(cand_ei))
    rmax = -(-(int(np.max(rlen)) if c else 1) // 16) * 16

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)

    cand_ei = put(cand_ei, np.int64)
    qlen = put(qlen, np.int32)
    lo = put(lo, np.int64)
    rlen = put(rlen, np.int32)
    cand_rd = put(cand_rd, np.int64)
    q, r = _decode_windows(packed, codes_mat, cand_ei, qlen, lo >> 4,
                           lo & 15, rlen, rmax)
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, mask_len=mask_len)
    no_term = torch.full((c,), -1, dtype=torch.int32, device=dev)
    # score-value-only sweep over every candidate: selection needs nothing
    # else, and the full fields run on the <= nr winner rows only
    sc = sw_pass_cuda(q, qlen, r, rlen, no_term, pad_to=16, score_only=True,
                      **kw)["score"]

    best = torch.full((nr,), -1, dtype=torch.int32, device=dev)
    best = best.scatter_reduce(0, cand_rd, sc, "amax")
    rowid = torch.arange(c, dtype=torch.int32, device=dev)
    isb = sc == best[cand_rd]
    win = torch.full((nr,), _I32_MAX, dtype=torch.int32, device=dev)
    win = win.scatter_reduce(0, cand_rd, torch.where(isb, rowid, _I32_MAX),
                             "amin")
    wv = torch.clamp(win, 0, max(c - 1, 0)).long()

    # full-field forward pass on just the winner rows: SW lanes are
    # independent, so each row's fields are bit-identical to the ones a
    # full-batch pass would return for it
    qw, rw, qlw, rlw = q[wv], r[wv], qlen[wv], rlen[wv]
    out = sw_pass_cuda(qw, qlw, rw, rlw, torch.full_like(qlw, -1), pad_to=16,
                       **kw)
    # reverse pass (ssw.c:860-875): reversed prefixes, terminate at score
    q_end, r_end = out["read_end"], out["ref_end"]
    q_rev, r_rev = _reverse_prefixes(qw, rw, q_end.long(), r_end.long())
    rev = sw_pass_cuda(q_rev, _lens(q_end + 1), r_rev, _lens(r_end + 1),
                       out["score"].contiguous(), pad_to=16, **kw)
    out["ref_begin"] = r_end - rev["ref_end"]
    out["read_begin"] = q_end - rev["read_end"]
    # one device -> host copy for the whole result
    stacked = torch.stack([win] + [out[k].to(torch.int32)
                                   for k in WINNER_FIELDS]).cpu().numpy()
    return stacked[0], {k: stacked[i + 1]
                        for i, k in enumerate(WINNER_FIELDS)}


def sw_align_begins(query, qlen, ref, rlen, fwd_rows, *, match=2,
                    mismatch=2, gap_open=3, gap_extend=1, mask_len=15):
    """The reverse pass of ssw_align (src/ssw.c:860-875) for rows whose
    forward results are already known: reversed query prefix [0..read_end]
    vs reversed ref prefix [0..ref_end], terminating at the forward score.

    fwd_rows: dict with at least score / read_end / ref_end int [B]
    tensors. Returns {"ref_begin", "read_begin"} int32 [B] tensors —
    bit-identical to the fields sw_align_ends computes on the full batch
    (same byte/word overflow split keyed off the forward score).
    """
    query, ref = _codes(query), _codes(ref)
    q_end = _lens(fwd_rows["read_end"])
    r_end = _lens(fwd_rows["ref_end"])
    score = _lens(fwd_rows["score"])
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, mask_len=mask_len)
    q_rev, r_rev = _reverse_prefixes(query, ref, q_end.long(), r_end.long())
    rev = _ssw_pass(q_rev, _lens(q_end + 1), r_rev, _lens(r_end + 1), score,
                    score=score, **kw)
    return {
        "ref_begin": r_end - rev["ref_end"],
        "read_begin": q_end - rev["read_end"],
    }
