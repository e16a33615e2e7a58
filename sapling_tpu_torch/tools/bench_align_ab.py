"""A/B aligner configurations against ONE loaded index artifact (PyTorch
port; the twin of tools/bench_align_ab.py).

    python -m sapling_tpu_torch.tools.bench_align_ab [n=230000000]
        [reads=100000] [len=100] [sub=0.01] [repeats=2]
        [configs=base,block32k,coalesce4]
        [index=.bench_cache/align_<n>_k16.stpu.npz] [device=cuda]

Loads the aligner artifact once (bench_align's loader: memory-mapped, the
host-gathered arrays copied into RAM; without one, an index below 1 Gbp is
built and saved there), simulates one read corpus, then for each named
config runs one full untimed warm pass and `repeats` timed passes and
reports the median reads/s (host clock) and the phase shares.

Configs:
  base       block=16384 workers=8 coalesce=2 (the default)
  block32k   block=32768 workers=8 coalesce=1 (half the blocks)
  coalesce4  block=16384 workers=8 coalesce=4 (one seed query for four
             blocks)

The JAX tool's `seedcu` config turns on compact_unresolved for the seed
queries, a TPU workaround the port does not carry: it is refused.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..align.aligner import SeedExtendAligner
from ..config import AlignerConfig, parse_keyval_args
from .bench_align import (aligner_index, aligner_pass, phase_shares,
                          simulated_reads)
from .build_big_index import CACHE

CONFIGS = {
    "base": dict(block=16384, workers=8, coalesce=2),
    "block32k": dict(block=32768, workers=8, coalesce=1),
    "coalesce4": dict(block=16384, workers=8, coalesce=4),
}


def main(argv):
    kv = parse_keyval_args(argv[1:])
    n = int(kv.get("n", 230_000_000))
    n_reads = int(kv.get("reads", 100_000))
    rlen = int(kv.get("len", 100))
    repeats = int(kv.get("repeats", 2))
    names = kv.get("configs", ",".join(CONFIGS)).split(",")
    device = torch.device(kv.get("device", "cuda"))
    path = kv.get("index", os.path.join(CACHE, f"align_{n}_k16.stpu.npz"))
    if "seedcu" in names:
        raise SystemExit("seedcu turns on compact_unresolved, a TPU "
                         "workaround the port does not carry")
    unknown = [nm for nm in names if nm not in CONFIGS]
    if unknown:
        raise SystemExit(f"unknown configs {unknown}; known: "
                         f"{', '.join(CONFIGS)}")

    t0 = time.time()
    idx = aligner_index(n, path, device)
    print(f"index ready in {time.time()-t0:.1f}s (n={idx.n:,})", flush=True)
    reads, pos = simulated_reads(idx, n_reads, rlen,
                                 float(kv.get("sub", 0.01)))

    results = {}
    for name in names:
        c = CONFIGS[name]
        aligner = SeedExtendAligner(idx, AlignerConfig(), device=device)
        dt, _, _ = aligner_pass(aligner, reads, pos, **c)
        print(f"[{name}] warm {dt:.1f}s", flush=True)
        aligner.phase_seconds.clear()
        times = []
        for _ in range(repeats):
            dt, cnt, good = aligner_pass(aligner, reads, pos, **c)
            times.append(dt)
        rps = n_reads / float(np.median(times))
        results[name] = rps
        print(f"[{name}] {rps:,.1f} reads/s on {device} (median of "
              f"{repeats}: {['%.3f' % t for t in times]}; {cnt} aligned, "
              f"{good} within 10bp)\n  phases: "
              + phase_shares(aligner.phase_seconds), flush=True)
    print("A/B: " + "  ".join(f"{k}:{v:,.1f}" for k, v in results.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
