"""SAM-vs-truth alignment quality comparison.

Equivalent of eval/Aligner/AlignmentQuality.java:8-73: match records by
read name; an alignment is GOOD when chromosome matches and the 1-based
position is within a tolerance (10bp) of the truth record; counts
good / bad / unaligned.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class QualityReport:
    good: int = 0
    bad: int = 0
    unaligned: int = 0
    missing: int = 0

    @property
    def total(self) -> int:
        return self.good + self.bad + self.unaligned + self.missing


def _parse_sam(path_or_lines):
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.read().splitlines()
    else:
        lines = list(path_or_lines)
    out = {}
    for line in lines:
        if not line or line.startswith("@"):
            continue
        p = line.split("\t")
        name, flag, chrom, pos = p[0], int(p[1]), p[2], int(p[3])
        out[name] = (flag, chrom, pos)
    return out


def compare_sam(produced, truth, tolerance: int = 10) -> QualityReport:
    got = _parse_sam(produced)
    want = _parse_sam(truth)
    rep = QualityReport()
    for name, (tflag, tchrom, tpos) in want.items():
        if name not in got:
            rep.missing += 1
            continue
        flag, chrom, pos = got[name]
        if flag & 4:
            rep.unaligned += 1
        elif chrom == tchrom and abs(pos - tpos) <= tolerance:
            rep.good += 1
        else:
            rep.bad += 1
    return rep


def truth_sam_lines(names, chroms, positions0, flags=None):
    """Minimal truth SAM records from simulation metadata (0-based
    positions converted to SAM 1-based)."""
    out = []
    for i, name in enumerate(names):
        flag = 0 if flags is None else int(flags[i])
        out.append(f"{name}\t{flag}\t{chroms[i]}\t{int(positions0[i]) + 1}"
                   f"\t255\t*\t*\t0\t0\t*\t*")
    return out
