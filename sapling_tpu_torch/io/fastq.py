"""FASTQ ingestion.

Mirrors the reference aligner's 4-line reader (reference:
src/align.cpp:174-190): keeps lines 0 (name), 1 (sequence), 3 (quality);
the read name is the whole header line minus '@' (description included,
src/align.cpp:235).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Read:
    name: str
    seq: bytes
    qual: str


def read_fastq(path_or_bytes):
    """Yield Read records; truncated trailing records are dropped exactly
    like the reference (fewer than 4 lines -> stop)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        lines = bytes(path_or_bytes).split(b"\n")
    else:
        with open(path_or_bytes, "rb") as f:
            lines = f.read().split(b"\n")
    for i in range(0, len(lines) - 3, 4):
        name, seq, _plus, qual = lines[i : i + 4]
        yield Read(name=name[1:].decode(), seq=bytes(seq), qual=qual.decode())
