"""Seed-and-extend read aligner CLI (PyTorch port).

Usage (same argument order and key=val flags as the reference binary,
reference: src/align.cpp:28-67, plus the device):

    python -m sapling_tpu_torch.tools.align <query.fastq> <ref.fasta> \
        <out.sam> [num_seeds=7] [sapling_k=16] [flanking_sequence=2] \
        [max_hits=32] [device=cuda|cpu]

The index is cached beside the FASTA as <ref>_k<k>_b-1.stpu.npz and
<ref>.sa, the same artifacts `tools/align.py` of the JAX package reads and
writes.
"""

from __future__ import annotations

import sys

from ..align.aligner import SeedExtendAligner
from ..config import AlignerConfig, IndexConfig, parse_keyval_args
from ..index.sapling import SaplingIndex


def main(argv):
    if len(argv) < 4:
        print(__doc__)
        return 1
    query_fn, ref_fn, out_fn = argv[1], argv[2], argv[3]
    kv = parse_keyval_args(argv[4:])
    cfg = AlignerConfig(
        num_seeds=int(kv.get("num_seeds", 7)),
        sapling_k=int(kv.get("sapling_k", 16)),
        flanking=int(kv.get("flanking_sequence", 2)),
        max_hits=int(kv.get("max_hits", 32)),
    )
    device = kv.get("device", "cuda")
    idx = SaplingIndex.from_fasta(ref_fn, IndexConfig(k=cfg.sapling_k),
                                  device=device)
    aligner = SeedExtendAligner(idx, cfg, device=device)
    aligner.align_fastq(query_fn, out_fn, cl=" ".join(argv))
    print(f"wrote {out_fn}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
