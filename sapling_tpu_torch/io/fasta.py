"""FASTA ingestion with the reference's filtering semantics.

Mirrors the inline parser in the Sapling constructor
(reference: src/sapling_api.h:517-548): lowercase is uppercased, every
non-ACGT character is dropped, and `chr_ends` records, per sequence, the
cumulative count of kept characters at the end of that sequence (keyed by
that count, i.e. later same-count entries overwrite earlier ones, exactly
like the reference's std::map<size_t, string>).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

_KEEP = np.zeros(256, dtype=bool)
for _b in b"ACGT":
    _KEEP[_b] = True
_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a") : ord("z") + 1] = np.arange(ord("A"), ord("Z") + 1, dtype=np.uint8)


@dataclass
class Genome:
    """A filtered genome: ASCII uint8 array + chromosome end map."""

    seq: np.ndarray                    # uint8 ASCII, ACGT only
    chr_ends: list[tuple[int, str]]    # sorted (cum_end, name)

    @property
    def n(self) -> int:
        return int(self.seq.shape[0])

    def name_at(self, pos: int) -> tuple[str, int]:
        """(chromosome name, offset within it) for a genome position.

        Replicates the aligner's chrEnds scan (reference: src/align.cpp:354-372):
        the chromosome is the one whose end is the smallest end > pos; the
        offset subtracts the largest end <= pos.
        """
        best_end, name = 0, "*"
        last_end = 0
        for end, nm in self.chr_ends:
            if end > pos and (best_end == 0 or end < best_end):
                best_end, name = end, nm
            if end <= pos and (last_end == 0 or end > last_end):
                last_end = end
        return name, pos - last_end


def read_fasta(path_or_bytes) -> Genome:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    chunks: list[np.ndarray] = []
    ends: dict[int, str] = {}
    count = 0
    cur_name = ""
    for line in io.BytesIO(data).read().split(b"\n"):
        if line.startswith(b">"):
            if cur_name:
                ends[count] = cur_name
            cur_name = line.split(b" ")[0][1:].decode().strip()
        elif line:
            arr = _UPPER[np.frombuffer(line, dtype=np.uint8)]
            arr = arr[_KEEP[arr]]
            count += arr.shape[0]
            chunks.append(arr)
    if cur_name:
        ends[count] = cur_name
    seq = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.uint8)
    return Genome(seq=seq, chr_ends=sorted(ends.items()))


def write_fasta(path: str, records: list[tuple[str, bytes]], width: int = 70):
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + b"\n")
