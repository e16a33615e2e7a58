"""Index build + timed query benchmark (PyTorch port).

Same CLI surface as tools/sapling_example.py and the reference benchmark
binary (reference: src/sapling_example.cpp:30-99), plus the device:

    python -m sapling_tpu_torch.tools.sapling_example <genome.fa>
        [sapFn=..] [nb=<log2 buckets>] [maxMem=<genome/val bucket cap>]
        [k=<k>] [nq=<num queries>] [errFn=<error dump>]
        [qLen=<query length>] [batch=1000000] [seed=0] [device=cuda|cpu]

Runs the reference's experiment sweep (qLen in {k-10, k, k+10, k+20,
k+30, k+80}, or one qLen) over nq random genome substrings: the plQuery
and then the classic binary-search baseline, each over all nq queries in
batches, timed with CUDA events on a card and the host clock on the CPU,
and every answer self-checked by substring equality (reference:
src/sapling_example.cpp:106-155). The index is cached beside the FASTA as
<genome>_k<k>_b<nb>.stpu.npz and <genome>.sa, the artifacts of the JAX
package's tool.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..config import IndexConfig, parse_keyval_args
from ..index.sapling import SaplingIndex
from ..utils.timing import timed


def run_experiment(idx, qlen: int, nq: int, batch: int, rng) -> None:
    """One qLen of the sweep on `idx` (an index on its query device)."""
    if not 0 < qlen <= idx.n:
        print(f"qLen {qlen} outside 1..{idx.n}; skipped")
        return
    starts = rng.integers(0, idx.n - qlen + 1, nq)
    codes2d = idx.codes[starts[:, None] + np.arange(qlen)]
    spans = range(0, nq, batch)
    inputs = [idx.query_inputs(codes2d[i:i + batch]) for i in spans]
    # the general path's inputs hold the packed words already
    words = [inp[2] if inp[2] is not None
             else idx.query_words(codes2d[i:i + batch])
             for i, inp in zip(spans, inputs)]

    def plq():
        return [idx.query_device(*inp, qlen) for inp in inputs]

    def bsq():
        return [idx.binsearch_device(w, qlen) for w in words]

    for name, fn in (("piecewise linear", plq), ("binary-search baseline",
                                                  bsq)):
        fn()                                   # warm: first-use setup
        outs, dt = timed(fn, idx.device)
        pos = np.concatenate([o.cpu().numpy() for o in outs])
        good = int(idx.verify_hits(codes2d, pos).sum())
        print(f"qLen={qlen}: {name}: {nq} queries in {dt:.3f}s "
              f"({nq / dt:,.0f} q/s); correctness: {good} out of {nq}")


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 0
    ref_fn = argv[1]
    kv = parse_keyval_args(argv[2:])
    cfg = IndexConfig(
        k=int(kv.get("k", -1)) if int(kv.get("k", -1)) > 0 else 21,
        buckets=int(kv.get("nb", -1)),
        max_mem=int(kv.get("maxMem", 10)),
    )
    nq = int(kv.get("nq", 5_000_000))
    qlen = int(kv.get("qLen", -1))
    batch = int(kv.get("batch", 1_000_000))

    t0 = time.time()
    idx = SaplingIndex.from_fasta(ref_fn, cfg,
                                  device=kv.get("device", "cuda"))
    print(f"index ready in {time.time() - t0:.1f}s "
          f"(n={idx.n}, buckets=2^{idx.buckets})")
    if kv.get("errFn"):
        # every signed per-k-mer prediction error in the reference's
        # `.errors` text format (src/sapling_api.h:456-481), which the
        # reference eval tools read (eval/ErrorsPerBin/PerBinErrors.java)
        from ..index.pwl import error_audit
        from ..io import artifacts
        from ..ops.pack import kmers_scan
        from ..ops.predict import predict_pwl_f64

        inv64, lcp64 = artifacts.read_sa(ref_fn + ".sa")
        kmers = kmers_scan(idx.codes, idx.k)
        audit = error_audit(kmers, inv64, lcp64, idx.table.xlist,
                            idx.table.ylist, idx.k, idx.buckets, idx.n)
        pred = predict_pwl_f64(kmers, idx.table.xlist, idx.table.ylist,
                               2 * idx.k, idx.buckets, idx.n)
        artifacts.write_errors_text(kv["errFn"], kmers,
                                    inv64[: kmers.shape[0]], pred,
                                    audit.errors, idx.buckets)
        print(f"wrote {kv['errFn']} "
              f"({audit.perfect_predictions} perfect predictions)")
    if kv.get("sapFn"):
        idx.write_reference_artifacts(kv["sapFn"])
        print(f"wrote {kv['sapFn']}")

    rng = np.random.default_rng(int(kv.get("seed", 0)))
    k = idx.k
    for ql in ((k - 10, k, k + 10, k + 20, k + 30, k + 80) if qlen == -1
               else (qlen,)):
        run_experiment(idx, ql, nq, batch, rng)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
