"""Add the per-bucket window bounds to an existing index artifact (PyTorch
port; the twin of tools/add_bucket_bounds.py).

    python -m sapling_tpu_torch.tools.add_bucket_bounds <index.stpu.npz>

Recomputes the prediction-error audit from the artifact's own codes+inv
(UNSHIFTED errors — the lcp>=k runs used for the KRMQ shift are not
persisted; unshifted |error| >= shifted |error|, so the resulting bounds
are conservative supersets and remain correct windows), derives the
packed per-bucket max bounds (index.pwl.bucket_bounds), and re-saves the
artifact as format v3. No-op if bounds are already present. The
prediction is ops.predict.predict_pwl on numpy (xp=np): host only.
"""

from __future__ import annotations

import gc
import sys

import numpy as np

from ..index.pwl import bucket_bounds
from ..index.sapling import SaplingIndex
from ..ops.pack import kmers_scan
from ..ops.predict import predict_pwl
from .build_big_index import log


def main(argv):
    path = argv[1]
    idx = SaplingIndex.load(path, device="cpu")
    if idx.table.bounds is not None:
        log("bounds already present; nothing to do")
        return 0
    if idx.codes is None:
        raise SystemExit("artifact lacks host codes; rebuild instead")
    k, nb, n = idx.k, idx.buckets, idx.n
    t = idx.table
    log(f"k-mer scan (n={n:,})")
    kmers = kmers_scan(idx.codes, k)
    m = kmers.shape[0]
    errors = np.empty(m, dtype=np.int32)
    chunk = 1 << 26
    log("audit (unshifted)")
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        pred = predict_pwl(kmers[lo:hi], t.xlist, t.ylist, 2 * k, nb, n,
                           xp=np)
        diff = idx.inv[lo:hi].astype(np.int64) - pred
        # unshifted multi-Gbp errors can exceed int32; clipping is exact
        # here because bucket_bounds saturates at the 0xFFFF sentinel
        np.clip(diff, -(2**31) + 1, 2**31 - 1, out=diff)
        errors[lo:hi] = diff.astype(np.int32)
    log("bucket bounds")
    idx.table.bounds = bucket_bounds(kmers, errors, 2 * k, nb)
    del kmers, errors
    gc.collect()
    log(f"re-saving {path} (v3)")
    idx.save(path)
    log("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
