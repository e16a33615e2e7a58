"""Chromosome- to genome-scale index build on the host, in stages that
free each input as soon as the next stage no longer needs it (PyTorch
port; the twin of tools/build_big_index.py, whose artifacts it writes
array for array).

    python -m sapling_tpu_torch.tools.build_big_index [n=3100000000] [k=21]
        [nb=26] [out=.bench_cache/bench_<n>_k<k>.stpu.npz] [aligner=0]
        [bounds=0] [stage=1] [workers=N] [inv=0]

The genome is sim.genomes.benchmark_genome(n). Ranks are stored as
uint32 below 2^32 bases; from 2^32 on, build_split stores split limbs
(uint32 low + uint8 high, format v4). aligner=1 also keeps the
uint8-capped lcp>=k run arrays so that the artifact drives
SeedExtendAligner (build it with k=16, the aligner's sapling_k);
bounds=1 adds the per-bucket window bounds; stage=0 skips writing the
~9 B/bp stage cache of SA-IS + Kasai outputs (disk-constrained hosts);
inv=1 keeps the inverse limbs in a split artifact. The build runs on the
host only (numpy, the native library, fork workers through
utils.parhost): run it in a process that has not touched CUDA.

Stage memory (3.1 Gbp): genome 3.1 + SA 25 + (inv,lcp) 50 transient ->
uint32 inv 12.5 + int32 lcp-runs 12.5 + kmers 25 + argsort 25 + errors
12.5 — peak ~95 GB.
"""

from __future__ import annotations

import gc
import os
import sys
import time

import numpy as np

from ..config import parse_keyval_args
from ..index.pwl import (PwlTable, SplitInv, bucket_bounds,
                         build_checkpoints_fast, error_audit,
                         error_audit_hist, error_stats, error_stats_from_hist)
from ..index.sapling import SaplingIndex
from ..index.suffix_array import fwd_runs_from_mask
from ..native import build_suffix_array, lcp_ge_k_fwd_split, lcp_kasai
from ..ops import pack as packops
from ..sim.genomes import benchmark_genome
from ..utils import parhost

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE = os.path.join(ROOT, ".bench_cache")


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _capped_runs_from_fwd(fwd: np.ndarray, chunk: int = 1 << 26):
    """uint8-capped (lcpk_fwd, lcpk_bwd) aligner run arrays from the
    int32 forward runs (index.suffix_array.lcp_ge_k_runs semantics;
    ok = fwd > 0 reconstructs the lcp>=k mask, the backward runs scan
    chunk-wise with a carry so no n-sized int64 temporaries appear)."""
    m = fwd.shape[0]
    f8 = np.empty(m, np.uint8)
    b8 = np.empty(m, np.uint8)
    run = 0
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        fc = fwd[lo:hi]
        f8[lo:hi] = np.minimum(fc, 255).astype(np.uint8)
        ok = fc > 0
        idxs = np.arange(hi - lo, dtype=np.int64)
        prev = np.maximum.accumulate(np.where(~ok, idxs, -1))
        b = idxs - prev
        b[prev == -1] += run
        run = int(b[-1]) if ok[-1] else 0
        b8[lo:hi] = np.minimum(b, 255).astype(np.uint8)
    return f8, b8


def kmers_span(span):
    """parhost worker: the k-mers of [lo, hi) from ctx()["codes"]."""
    lo, hi = span
    c = parhost.ctx()
    k = c["k"]
    # windows ending past hi belong to the next span; overlap k-1 codes
    return lo, packops.kmers_scan(
        c["codes"][lo : hi + k - 1], k)[: hi - lo]


def kmers_forked(codes: np.ndarray, k: int, workers: int) -> np.ndarray:
    """int64 k-mers of every genome window, in 2^26-window spans over
    fork workers."""
    m = codes.shape[0] - k + 1
    kmers = np.empty(m, dtype=np.int64)
    for lo, kch in parhost.run_forked(
            kmers_span, parhost.spans_of(m, 1 << 26),
            {"codes": codes, "k": k}, workers=workers):
        kmers[lo : lo + kch.shape[0]] = kch
    return kmers


def main(argv):
    kv = parse_keyval_args(argv[1:])
    n = int(kv.get("n", 3_100_000_000))
    k = int(kv.get("k", 21))
    nb = int(kv.get("nb", 26))
    want_bounds = bool(int(kv.get("bounds", 0)))
    workers = int(kv.get("workers", parhost.default_workers()))
    out = kv.get("out", os.path.join(CACHE, f"bench_{n}_k{k}.stpu.npz"))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    if os.path.exists(out):
        log(f"{out} exists; nothing to do")
        return 0

    if n > 0xFFFFFFFE:
        return build_split(n, k, nb, workers, out,
                           keep_inv=bool(int(kv.get("inv", 0))))

    # Stage cache: SA-IS + Kasai are the irreducible serial stages
    # (~65% of a from-scratch build); their lean outputs are cached so
    # an interrupted build — or a rebuild with different nb — resumes
    # from here.
    stage = os.path.join(os.path.dirname(os.path.abspath(out)),
                         f"stage_{n}_k{k}.npz")
    t0 = time.time()
    if os.path.exists(stage):
        log(f"loading stage cache {stage}")
        with np.load(stage) as z:
            codes, inv32, fwd = z["codes"], z["inv32"], z["fwd"]
    else:
        log(f"generating {n/1e9:.2f} Gbp benchmark genome")
        seq = benchmark_genome(n)
        log(f"genome done ({time.time()-t0:.0f}s); SA-IS (int64)")

        t1 = time.time()
        sa = build_suffix_array(seq, np.int64)
        log(f"SA-IS done ({time.time()-t1:.0f}s); Kasai LCP")
        t1 = time.time()
        inv, lcp = lcp_kasai(seq, sa)
        del sa
        gc.collect()
        log(f"Kasai done ({time.time()-t1:.0f}s); deriving lean arrays")

        ok = lcp >= k
        del lcp
        gc.collect()
        fwd = fwd_runs_from_mask(ok)
        del ok
        gc.collect()
        inv32 = inv.astype(np.uint32)
        del inv
        gc.collect()

        codes = packops.encode_bases(seq)
        del seq
        gc.collect()
        if bool(int(kv.get("stage", 1))):
            log(f"saving stage cache {stage}")
            np.savez(stage, codes=codes, inv32=inv32, fwd=fwd)
        else:
            log("stage=0: skipping stage cache (saves ~9 B/bp disk)")

    log(f"k-mer scan ({workers} workers)")
    t1 = time.time()
    kmers = kmers_forked(codes, k, workers)
    lcpk8 = None
    if bool(int(kv.get("aligner", 0))):
        # aligner=1: keep the uint8-capped lcp>=k run arrays (and inv,
        # already kept on this path) so the artifact drives the full
        # SeedExtendAligner at this scale (use k=16, the aligner's
        # sapling_k)
        log("deriving aligner run arrays (uint8 capped)")
        lcpk8 = _capped_runs_from_fwd(fwd)
    log(f"kmers done ({time.time()-t1:.0f}s); PWL checkpoints (sort-free)")
    t1 = time.time()
    xlist, ylist = build_checkpoints_fast(kmers, inv32, 2 * k, nb,
                                          workers=workers)
    log(f"checkpoints done ({time.time()-t1:.0f}s); error audit "
        f"({workers} workers)")
    t1 = time.time()
    audit = error_audit(kmers, inv32, None, xlist, ylist, k, nb, n,
                        fwd=fwd, workers=workers)
    del fwd
    gc.collect()
    bnd = (bucket_bounds(kmers, audit.errors, 2 * k, nb)
           if want_bounds else None)
    del kmers
    gc.collect()
    mo, mu, me, so, su = error_stats(audit)
    log(f"audit done ({time.time()-t1:.0f}s): max=({mo},{mu}) "
        f"most=({so},{su}) mean={me} perfect={audit.perfect_predictions}")
    del audit
    gc.collect()

    table = PwlTable(buckets=nb, xlist=xlist, ylist=ylist, max_over=mo,
                     max_under=mu, mean_error=me, most_over=so,
                     most_under=su, bounds=bnd)
    log("building rev (uint32) + packing genome")
    rev = np.empty(n, dtype=np.uint32)
    rev[inv32] = np.arange(n, dtype=np.uint32)
    packed = packops.pack_codes(codes, pad_words=16)
    idx = SaplingIndex(n=n, k=k, buckets=nb, packed=packed, rev=rev,
                       inv=inv32, table=table, chr_ends=[(n, "big1")],
                       codes=codes)
    if lcpk8 is not None:
        idx.lcpk_fwd, idx.lcpk_bwd = lcpk8
    log(f"saving {out}")
    idx.save(out)
    log(f"TOTAL {time.time()-t0:.0f}s")
    return 0


def build_split(n, k, nb, workers, out, keep_inv=False):
    """>= 2^32-base build: split-limb ranks end to end.

    Never materializes an 8-byte-per-entry rank or LCP array: the fused
    native Kasai (native.lcp_ge_k_fwd_split) emits uint32+uint8 inverse
    limbs and int32 lcp>=k runs directly; k-mers derive per chunk from
    the 2-bit codes inside fork workers (index.pwl build_checkpoints_fast
    codes path); the audit streams an error-value histogram
    (error_audit_hist) instead of a 4n-byte errors array. Peak host RAM
    at 4.7 Gbp ~= 84 GB (SA-IS + fused Kasai stage); later stages stay
    under ~55 GB. keep_inv persists the inverse limbs in the artifact
    (the query only needs rev; +~5n bytes of disk)."""
    t0 = time.time()
    stage = os.path.join(os.path.dirname(os.path.abspath(out)),
                         f"stage_{n}_k{k}_split.npz")
    if os.path.exists(stage):
        log(f"loading stage cache {stage}")
        with np.load(stage) as z:
            codes, inv_lo, inv_hi, fwd = (z["codes"], z["inv_lo"],
                                          z["inv_hi"], z["fwd"])
    else:
        log(f"generating {n/1e9:.2f} Gbp benchmark genome")
        seq = benchmark_genome(n)
        log(f"genome done ({time.time()-t0:.0f}s); SA-IS (int64)")
        t1 = time.time()
        sa = build_suffix_array(seq, np.int64)
        log(f"SA-IS done ({time.time()-t1:.0f}s); fused Kasai "
            f"(split inv + lcp>=k runs)")
        t1 = time.time()
        inv_lo, inv_hi, fwd = lcp_ge_k_fwd_split(seq, sa, k)
        del sa
        gc.collect()
        log(f"fused Kasai done ({time.time()-t1:.0f}s)")
        codes = packops.encode_bases(seq)
        del seq
        gc.collect()
        log(f"saving stage cache {stage}")
        np.savez(stage, codes=codes, inv_lo=inv_lo, inv_hi=inv_hi, fwd=fwd)

    log(f"PWL checkpoints (codes-derived k-mers, {workers} workers)")
    t1 = time.time()
    xlist, ylist = build_checkpoints_fast(
        None, SplitInv(inv_lo, inv_hi), 2 * k, nb, workers=workers,
        codes=codes, k=k)
    log(f"checkpoints done ({time.time()-t1:.0f}s); streamed error audit")
    t1 = time.time()
    vals, counts, perfect = error_audit_hist(
        codes, inv_lo, inv_hi, fwd, xlist, ylist, k, nb, n,
        workers=workers)
    del fwd
    gc.collect()
    mo, mu, me, so, su = error_stats_from_hist(vals, counts, perfect)
    log(f"audit done ({time.time()-t1:.0f}s): max=({mo},{mu}) "
        f"most=({so},{su}) mean={me} perfect={perfect}")

    table = PwlTable(buckets=nb, xlist=xlist, ylist=ylist, max_over=mo,
                     max_under=mu, mean_error=me, most_over=so,
                     most_under=su, bounds=None)
    log("building split rev (chunked scatter) + packing genome")
    rev_lo = np.empty(n, dtype=np.uint32)
    rev_hi = np.empty(n, dtype=np.uint8)
    chunk = 1 << 27
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        r = (inv_lo[lo:hi].astype(np.int64)
             | (inv_hi[lo:hi].astype(np.int64) << 32))
        pos = np.arange(lo, hi, dtype=np.int64)
        rev_lo[r] = (pos & 0xFFFFFFFF).astype(np.uint32)
        rev_hi[r] = (pos >> 32).astype(np.uint8)
    packed = packops.pack_codes(codes, pad_words=16)
    idx = SaplingIndex(
        n=n, k=k, buckets=nb, packed=packed, rev=rev_lo, rev_hi=rev_hi,
        inv=inv_lo if keep_inv else np.zeros(0, np.uint32),
        inv_hi=inv_hi if keep_inv else None, table=table,
        chr_ends=[(n, "big1")], codes=codes)
    log(f"saving {out}")
    idx.save(out)
    log(f"TOTAL {time.time()-t0:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
