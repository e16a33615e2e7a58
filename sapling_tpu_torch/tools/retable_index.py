"""Rebuild the PWL bucket table of a saved index at another bucket
count, without re-running SA-IS or Kasai (PyTorch port; the twin of
tools/retable_index.py, whose outputs it writes array for array).

    python -m sapling_tpu_torch.tools.retable_index <index.stpu.npz> nb=27
        [out=<index>_nb27.table.npz] [workers=N] [full=0]

It re-runs sweep 1 (checkpoints) and sweep 2 (the error audit) from the
artifact's own codes + inv, deriving the lcp>=k runs from k-mer equality
in rank space (index.suffix_array.fwd_runs_from_rank_kmers) instead of a
Kasai pass. The default output is a small table-only npz
(xlist/ylist/stats/buckets and the source's n and k) that
SaplingIndex.swap_table, tools/swap_table_artifact.py and
bench_query_scale's table= take; full=1 writes a complete new index
artifact instead. Host only: run it in a process that has not touched
CUDA (the sweeps fork workers).
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np

from ..config import parse_keyval_args
from ..index.pwl import (PwlTable, build_checkpoints_fast, error_audit,
                         error_stats)
from ..index.sapling import SaplingIndex
from ..index.suffix_array import fwd_runs_from_rank_kmers
from ..io import artifacts
from ..utils import parhost
from .build_big_index import kmers_forked, log


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    src = argv[1]
    kv = parse_keyval_args(argv[2:])
    nb = int(kv["nb"])
    workers = int(kv.get("workers", parhost.default_workers()))
    full = bool(int(kv.get("full", 0)))
    out = kv.get("out")
    if out is None:
        stem = src[: -len(".stpu.npz")] if src.endswith(".stpu.npz") else src
        out = f"{stem}_nb{nb}" + (".stpu.npz" if full else ".table.npz")
    if os.path.exists(out):
        log(f"{out} exists; nothing to do")
        return 0

    t0 = time.time()
    idx = SaplingIndex.load(src, skip=("lcpk_fwd", "lcpk_bwd", "rev_hi")
                            if not full else (), mmap=True)
    if idx.inv is None or len(idx.inv) != idx.n:
        raise SystemExit(f"{src} has no full inv array — cannot retable")
    if idx.inv_hi is not None:
        raise SystemExit("split-limb (inv_hi) retable unsupported here")
    if idx.codes is None:
        raise SystemExit(f"{src} carries no codes — cannot retable")
    n, k = idx.n, idx.k
    log(f"mapped {src} (n={n:,}, k={k}, 2^{idx.buckets} -> 2^{nb}) "
        f"in {time.time()-t0:.0f}s")
    codes = np.array(idx.codes)
    inv = np.array(idx.inv)

    log(f"k-mer scan ({workers} workers)")
    t1 = time.time()
    kmers = kmers_forked(codes, k, workers)
    log(f"kmers done ({time.time()-t1:.0f}s); deriving lcp>=k runs "
        f"from rank k-mer equality")
    t1 = time.time()
    fwd = fwd_runs_from_rank_kmers(kmers, inv, n)
    gc.collect()
    log(f"runs done ({time.time()-t1:.0f}s); checkpoints (sort-free, "
        f"{workers} workers)")
    t1 = time.time()
    xlist, ylist = build_checkpoints_fast(kmers, inv, 2 * k, nb,
                                          workers=workers)
    log(f"checkpoints done ({time.time()-t1:.0f}s); error audit")
    t1 = time.time()
    audit = error_audit(kmers, inv, None, xlist, ylist, k, nb, n,
                        fwd=fwd, workers=workers)
    del fwd, kmers
    gc.collect()
    mo, mu, me, so, su = error_stats(audit)
    log(f"audit done ({time.time()-t1:.0f}s): max=({mo},{mu}) "
        f"most=({so},{su}) mean={me} perfect={audit.perfect_predictions}")
    del audit
    gc.collect()

    if full:
        idx.table = PwlTable(buckets=nb, xlist=xlist, ylist=ylist,
                             max_over=mo, max_under=mu, mean_error=me,
                             most_over=so, most_under=su)
        idx.buckets = nb
        idx.codes = codes
        idx.inv = inv
        log(f"saving full artifact {out}")
        idx.save(out)
    else:
        log(f"saving table-only {out}")
        artifacts.save_npz(
            out, buckets=np.int64(nb), xlist=xlist, ylist=ylist,
            stats=np.array([mo, mu, me, so, su], dtype=np.int64),
            src_n=np.int64(n), src_k=np.int64(k))
    log(f"TOTAL {time.time()-t0:.0f}s")
    return 0


def load_table(path: str, n: int, k: int) -> PwlTable:
    """The PwlTable of a table-only npz (main's default output), which
    must have been built for an index of n bases at this k. It carries no
    per-bucket bounds."""
    z = artifacts.load_npz(path)
    if int(z["src_n"]) != n or int(z["src_k"]) != k:
        raise SystemExit(f"table {path} was built for n={int(z['src_n'])},"
                         f"k={int(z['src_k'])} — the index has n={n},k={k}")
    st = z["stats"]
    return PwlTable(buckets=int(z["buckets"]), xlist=z["xlist"],
                    ylist=z["ylist"], max_over=int(st[0]),
                    max_under=int(st[1]), mean_error=int(st[2]),
                    most_over=int(st[3]), most_under=int(st[4]))


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
