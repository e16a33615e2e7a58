"""SAM emission with the reference's exact formatting.

Replicates write_sam_alignment (reference: src/align.cpp:86-146) byte for
byte, including the MAPQ double-truncation: the C code converts the float
-4.343*ln(1 - d/s) to uint32 FIRST (truncating toward zero), then adds
4.99 and truncates again (src/align.cpp:102-104) — so e.g. 0.76 -> 0 ->
4.99 -> 4. For score2 == 0 the log is -inf and the uint32 conversion is
UB; on x86-64 cvttsd2si yields 0x80..0 whose low 32 bits are 0, so the
final MAPQ is 4 — we reproduce that observed behavior.
"""

from __future__ import annotations

import math

from .cigar import Alignment, cigar_str


def sam_header(chr_ends, cl: str) -> str:
    """@HD/@SQ/@PG block (reference: src/align.cpp:197-213); chr_ends is
    the sorted (cum_end, name) list; LN = this end minus the previous."""
    out = ["@HD\tVN:1.6\tSO:coordinate"]
    last = 0
    for end, name in chr_ends:
        out.append(f"@SQ\tSN:{name}\tLN:{end - last}")
        last = end
    out.append(f"@PG\tID:sapling\tVN:1.0\tCL:{cl}")
    return "\n".join(out) + "\n"


def mapq_of(score: int, score2: int) -> int:
    d = abs(score - score2)
    if score2 == 0 or d >= score:
        first = 0  # (uint32)(+inf) on x86-64 — see module docstring
    else:
        v = -4.343 * math.log(1.0 - d / score)
        first = int(v)  # truncate toward zero; v >= 0 here
    q = int(first + 4.99)
    return q if q < 254 else 254


def sam_record(name: str, read_seq: str, qual: str, aligned: bool,
               a: Alignment | None = None, ref_name: str = "",
               strand: int = 0) -> str:
    if not aligned:
        return f"{name}\t4\t*\t0\t255\t*\t*\t0\t0\t*\t*\n"
    mapq = mapq_of(a.sw_score, a.sw_score_next_best)
    flag = "16" if strand else "0"
    q = qual[::-1] if (qual and strand) else (qual if qual else "*")
    tail = f"\tAS:i:{a.sw_score}\tNM:i:{a.mismatches}\t"
    if a.sw_score_next_best > 0:
        tail += f"ZS:i:{a.sw_score_next_best}\n"
    else:
        tail += "\n"
    return (
        f"{name}\t{flag}\t{ref_name}\t{a.ref_begin + 1}\t{mapq}\t"
        f"{cigar_str(a.cigar)}\t*\t0\t0\t{read_seq}\t{q}" + tail
    )
