"""End-to-end aligner throughput benchmark (PyTorch port; the twin of
tools/bench_align.py).

Simulated reads against a saved benchmark-genome aligner index, the full
FASTQ -> SAM pipeline (seeding + SW extension + traceback + emission),
reads/s on the host clock with every result on the host, plus the
simulation-truth quality (AlignmentQuality semantics,
eval/Aligner/AlignmentQuality.java): aligned reads, and those within
10 bp of their true position.

    python -m sapling_tpu_torch.tools.bench_align [n=230000000]
        [reads=50000] [len=100] [sub=0.01] [block=16384] [workers=8]
        [coalesce=2] [index=.bench_cache/align_<n>_k16.stpu.npz]
        [device=cuda]

The index is an aligner artifact (k=16, with inv and the lcp>=k run
arrays), as `python -m sapling_tpu_torch.tools.build_big_index n=<n>
k=16 nb=26 aligner=1 out=<index>` writes it. It loads memory-mapped;
codes, inv and the run arrays are copied into RAM, because the host
phases gather from them at random. Without one, an index below 1 Gbp is
built in this process with SaplingIndex.build and saved there first.
One full untimed pass over the reads comes before the timed one (it
builds the SW kernel and makes the device arrays).

The JAX tool's ref=1 times the reference C++ aligner built from its
sources, which this repository does not carry: it is refused.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..align.aligner import SeedExtendAligner
from ..config import AlignerConfig, IndexConfig, parse_keyval_args
from ..index.sapling import SaplingIndex
from ..io.fastq import Read
from ..ops.pack import decode_bases
from ..sim.genomes import benchmark_genome, simulate_reads
from .build_big_index import CACHE


def load_aligner_index(path: str, device) -> SaplingIndex:
    """The artifact memory-mapped, with the arrays the aligner's host
    phases gather from at random copied into RAM."""
    idx = SaplingIndex.load(path, mmap=True, device=device)
    idx.codes = np.array(idx.codes)
    idx.inv = np.array(idx.inv)
    if idx.lcpk_fwd is not None:
        idx.lcpk_fwd = np.array(idx.lcpk_fwd)
        idx.lcpk_bwd = np.array(idx.lcpk_bwd)
    return idx


def aligner_index(n: int, path: str, device) -> SaplingIndex:
    """The aligner artifact at `path` (load_aligner_index), or, without
    one, an index of benchmark_genome(n) below 1 Gbp built here and saved
    there first."""
    if os.path.exists(path):
        return load_aligner_index(path, device)
    if n > 1_000_000_000:
        raise SystemExit(
            f"no aligner index at {path}; build it first:\n  python -m "
            f"sapling_tpu_torch.tools.build_big_index n={n} k=16 nb=26 "
            f"aligner=1 out={path}")
    idx = SaplingIndex.build(benchmark_genome(n), IndexConfig(k=16),
                             device=device)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    idx.save(path)
    return idx


def simulated_reads(idx: SaplingIndex, n_reads: int, rlen: int,
                    sub: float):
    """(reads, true 0-based positions): n_reads reads of rlen bases from
    the index's genome with `sub` substitutions (seed 42)."""
    reads_arr, pos, _rc = simulate_reads(decode_bases(idx.codes), n_reads,
                                         rlen, sub_rate=sub, seed=42)
    reads = [Read(name=f"r{i}", seq=reads_arr[i].tobytes(), qual="I" * rlen)
             for i in range(n_reads)]
    return reads, pos


def aligner_pass(aligner, reads, pos, block: int, workers: int,
                 coalesce: int):
    """One pass of align_blocks over the reads in blocks of `block`:
    (host seconds, aligned reads, reads within 10 bp of their truth)."""
    t0 = time.perf_counter()
    n_aligned = n_good = ri = 0
    blocks = (reads[lo : lo + block] for lo in range(0, len(reads), block))
    for out in aligner.align_blocks(blocks, workers=workers,
                                    coalesce=coalesce):
        for ar in out:
            if ar.aligned:
                n_aligned += 1
                if abs(ar.alignment.ref_begin - pos[ri]) <= 10:
                    n_good += 1
            ri += 1
    return time.perf_counter() - t0, n_aligned, n_good


def phase_shares(phase_seconds: dict) -> str:
    tot = sum(phase_seconds.values()) or 1.0
    return "  ".join(f"{k}={v:.2f}s({100*v/tot:.0f}%)"
                     for k, v in sorted(phase_seconds.items(),
                                        key=lambda kv: -kv[1]))


def main(argv):
    kv = parse_keyval_args(argv[1:])
    if int(kv.get("ref", 0)):
        raise SystemExit("ref=1 times the reference C++ aligner, whose "
                         "sources this repository does not carry")
    n = int(kv.get("n", 230_000_000))
    n_reads = int(kv.get("reads", 50_000))
    rlen = int(kv.get("len", 100))
    sub = float(kv.get("sub", 0.01))
    block = int(kv.get("block", 16384))
    workers = int(kv.get("workers", 8))
    coalesce = int(kv.get("coalesce", 2))
    device = torch.device(kv.get("device", "cuda"))
    path = kv.get("index", os.path.join(CACHE, f"align_{n}_k16.stpu.npz"))

    t0 = time.time()
    idx = aligner_index(n, path, device)
    print(f"index ready ({time.time()-t0:.1f}s, n={idx.n:,}, "
          f"buckets=2^{idx.buckets})", flush=True)
    reads, pos = simulated_reads(idx, n_reads, rlen, sub)
    aligner = SeedExtendAligner(idx, AlignerConfig(), device=device)
    dt, _, _ = aligner_pass(aligner, reads, pos, block, workers, coalesce)
    print(f"warm pass {dt:.1f}s", flush=True)
    aligner.phase_seconds.clear()
    dt, n_aligned, n_good = aligner_pass(aligner, reads, pos, block,
                                         workers, coalesce)
    print(f"aligned {n_reads} reads in {dt:.3f}s on {device} -> "
          f"{n_reads/dt:,.1f} reads/s")
    print(f"aligned: {n_aligned}/{n_reads}; within 10bp of truth: {n_good}")
    print("phases: " + phase_shares(aligner.phase_seconds))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
