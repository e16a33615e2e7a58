"""Rewrite a saved index artifact with a retabled PWL table, in place
(PyTorch port; the twin of tools/swap_table_artifact.py).

    python -m sapling_tpu_torch.tools.swap_table_artifact <index.stpu.npz>
        <table.npz>

The table npz comes from sapling_tpu_torch.tools.retable_index (its
table-only output). The artifact is loaded memory-mapped (members stream
through, ~no RAM), the table is swapped (SaplingIndex.swap_table), and
the artifact is replaced atomically (written to .tmp, then renamed). As
in the JAX tool, the new table carries no per-bucket bounds, so the
rewritten artifact has none; tools/add_bucket_bounds.py's twin
(sapling_tpu_torch.tools.add_bucket_bounds) adds them back. Host only.
"""

from __future__ import annotations

import os
import sys
import time

from ..index.sapling import SaplingIndex
from .retable_index import load_table


def main(argv):
    if len(argv) != 3:
        print(__doc__)
        return 1
    src, tab = argv[1], argv[2]
    t0 = time.time()
    idx = SaplingIndex.load(src, mmap=True, device="cpu")
    new = load_table(tab, idx.n, idx.k)
    old_b = idx.buckets
    idx.swap_table(new)
    tmp = src + ".tmp"
    print(f"rewriting {src} with 2^{old_b} -> 2^{idx.buckets} table "
          f"(most=({new.most_over},{new.most_under}) "
          f"max=({new.max_over},{new.max_under}))", flush=True)
    idx.save(tmp)
    os.replace(tmp, src)
    print(f"done in {time.time()-t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
