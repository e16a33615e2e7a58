"""CIGAR assembly for winning alignments.

Combines the device endpoint passes (sapling_tpu_torch.ops.sw) with the native
banded traceback (sapling_tpu_torch.native.banded_cigar), then applies the SSW
C++ wrapper's post-processing: soft-clip the unaligned read ends and split
M runs into '='/'X' while counting mismatches
(reference: src/ssw_cpp.cpp:54-92 ConvertAlignment,
:120-210 CalculateNumberMismatch; cigar int packing len<<4|op with
op M=0 I=1 D=2 S=4 '='=7 X=8, src/ssw.c:122-155).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..native import banded_cigar

OP_M, OP_I, OP_D, OP_S, OP_EQ, OP_X = 0, 1, 2, 4, 7, 8
_OP_CHAR = {OP_M: "M", OP_I: "I", OP_D: "D", OP_S: "S", OP_EQ: "=", OP_X: "X"}


def cig(length: int, op: int) -> int:
    return (int(length) << 4) | op


def cigar_str(ops: list[int]) -> str:
    return "".join(f"{o >> 4}{_OP_CHAR.get(o & 0xF, 'M')}" for o in ops)


@dataclass
class Alignment:
    """Mirror of StripedSmithWaterman::Alignment (reference:
    src/ssw_cpp.h:14-40) — window-relative coordinates."""

    sw_score: int = 0
    sw_score_next_best: int = 0
    ref_begin: int = -1
    ref_end: int = -1
    query_begin: int = -1
    query_end: int = -1
    ref_end_next_best: int = 0
    mismatches: int = 0
    cigar: list[int] = field(default_factory=list)

    @property
    def cigar_string(self) -> str:
        return cigar_str(self.cigar)


def finish_alignment(
    read_codes: np.ndarray,
    ref_codes: np.ndarray,
    ends: dict,
    *,
    match: int = 2,
    mismatch: int = 2,
    gap_open: int = 3,
    gap_extend: int = 1,
) -> Alignment | None:
    """Build the full Alignment record for ONE candidate from its endpoint
    dict (a row of sw_align_ends output).

    read_codes/ref_codes: int8 codes of the full read and the full ref
    window. Returns None when the banded traceback fails (candidate is
    skipped, reference src/align.cpp:336).
    """
    a = Alignment(
        sw_score=int(ends["score"]),
        sw_score_next_best=int(ends["score2"]),
        ref_begin=int(ends["ref_begin"]),
        ref_end=int(ends["ref_end"]),
        query_begin=int(ends["read_begin"]),
        query_end=int(ends["read_end"]),
        ref_end_next_best=int(ends["ref_end2"]),
    )
    ref_len = a.ref_end - a.ref_begin + 1
    read_len = a.query_end - a.query_begin + 1
    band = abs(ref_len - read_len) + 1  # ssw.c:885
    raw = banded_cigar(
        ref_codes[a.ref_begin : a.ref_end + 1],
        read_codes[a.query_begin : a.query_end + 1],
        a.sw_score, match, mismatch, gap_open, gap_extend, band,
    )
    if raw is None:
        return None
    a.cigar, a.mismatches = _mark_mismatch(
        list(raw), read_codes, ref_codes, a.query_begin, a.ref_begin,
        len(read_codes),
    )
    return a


def finish_alignments_batch(
    q: np.ndarray, r: np.ndarray, ql: np.ndarray, ends_rows: dict,
    *, match: int = 2, mismatch: int = 2, gap_open: int = 3,
    gap_extend: int = 1) -> list[Alignment | None]:
    """finish_alignment for a whole block of winning candidates in ONE
    native call (traceback + soft clips + '='/'X' split + mismatch count
    all in C++; the per-base Python loop in _mark_mismatch was a top-3
    cost of aligner blocks). Row b uses q[b]/r[b] full-window codes and
    ends_rows[...][b] endpoint fields. None rows = traceback failure."""
    from ..native import finish_batch

    cigs, n_ops, mism = finish_batch(
        q, r, ql, ends_rows["score"], ends_rows["ref_begin"],
        ends_rows["ref_end"], ends_rows["read_begin"],
        ends_rows["read_end"], match=match, mismatch=mismatch,
        gap_open=gap_open, gap_extend=gap_extend)
    out: list[Alignment | None] = []
    for b in range(len(n_ops)):
        if n_ops[b] < 0:
            out.append(None)
            continue
        out.append(Alignment(
            sw_score=int(ends_rows["score"][b]),
            sw_score_next_best=int(ends_rows["score2"][b]),
            ref_begin=int(ends_rows["ref_begin"][b]),
            ref_end=int(ends_rows["ref_end"][b]),
            query_begin=int(ends_rows["read_begin"][b]),
            query_end=int(ends_rows["read_end"][b]),
            ref_end_next_best=int(ends_rows["ref_end2"][b]),
            mismatches=int(mism[b]),
            cigar=cigs[b, : n_ops[b]].tolist(),
        ))
    return out


def _mark_mismatch(ops, read_codes, ref_codes, query_begin, ref_begin,
                   query_len):
    """CalculateNumberMismatch (reference: src/ssw_cpp.cpp:120-210):
    soft-clip both read ends, split M into '='/'X', count mismatches as
    X bases + I lengths + D lengths."""
    out: list[int] = []
    if query_begin > 0:
        out.append(cig(query_begin, OP_S))
    ri, qi = ref_begin, query_begin
    mismatches = 0
    run_op, run_len = None, 0

    def flush():
        nonlocal run_op, run_len
        if run_len:
            out.append(cig(run_len, run_op))
        run_op, run_len = None, 0

    for c in ops:
        op, length = c & 0xF, c >> 4
        if op == OP_M:
            for _ in range(length):
                eq = ref_codes[ri] == read_codes[qi]
                want = OP_EQ if eq else OP_X
                if run_op != want:
                    flush()
                    run_op = want
                run_len += 1
                if not eq:
                    mismatches += 1
                ri += 1
                qi += 1
        elif op == OP_I:
            flush()
            qi += length
            mismatches += length
            out.append(c)
        elif op == OP_D:
            flush()
            ri += length
            mismatches += length
            out.append(c)
    flush()
    query_end = qi - 1
    tail = query_len - query_end - 1
    if tail > 0:
        out.append(cig(tail, OP_S))
    return out, mismatches
