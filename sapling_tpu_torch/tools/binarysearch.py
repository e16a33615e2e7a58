"""Classic suffix-array binary-search benchmark (PyTorch port): the
baseline Sapling is measured against (reference: src/binarysearch.cpp:
167-273).

    python -m sapling_tpu_torch.tools.binarysearch <genome.fa> [nq=5000000]
        [qLen=21] [batch=1000000] [fancy=0] [device=cuda|cpu]

Same arguments as tools/binarysearch.py, plus the device. Runs nq random
genome substrings through the batched binary search in batches, timed
with CUDA events on a card and the host clock on the CPU, and self-checks
every answer by substring comparison. fancy=1 uses the Manber-Myers
llcp/rlcp-pruned variant (the reference's unused fancyBinarySearch,
src/binarysearch.cpp:90-153).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import IndexConfig, parse_keyval_args
from ..index.sapling import SaplingIndex
from ..index.suffix_array import build_llcp_rlcp, build_suffix_data
from ..utils.timing import timed


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    kv = parse_keyval_args(argv[2:])
    nq = int(kv.get("nq", 5_000_000))
    qlen = int(kv.get("qLen", 21))
    batch = int(kv.get("batch", 1_000_000))
    fancy = bool(int(kv.get("fancy", 0)))
    idx = SaplingIndex.from_fasta(argv[1], IndexConfig(k=min(qlen, 21)),
                                  device=kv.get("device", "cuda"))
    tables = None
    if fancy:   # host work, before the device is touched
        suffix = build_suffix_data(idx.codes)
        tables = build_llcp_rlcp(np.asarray(suffix.lcp, np.int64), idx.n)
    rng = np.random.default_rng(0)
    starts = rng.integers(0, idx.n - qlen + 1, nq)
    codes2d = idx.codes[starts[:, None] + np.arange(qlen)]
    words = [idx.query_words(codes2d[i:i + batch])
             for i in range(0, nq, batch)]
    lr = ([torch.from_numpy(a).to(idx.device) for a in tables] if fancy
          else [])

    def run(qw):
        return idx.binsearch_device(qw, qlen, *lr)

    run(words[0])                              # warm: first-use setup
    outs, dt = timed(lambda: [run(w) for w in words], idx.device)
    pos = np.concatenate([o.cpu().numpy() for o in outs])
    good = int(idx.verify_hits(codes2d, pos).sum())
    print(f"binary search: {nq} queries in {dt:.3f}s ({nq / dt:,.0f} q/s); "
          f"correctness: {good} out of {nq}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
