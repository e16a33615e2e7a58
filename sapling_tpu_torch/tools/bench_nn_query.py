"""A/B the NN-predictor query engine against the PWL engine on a saved
index artifact (PyTorch port; the twin of tools/bench_nn_query.py).

    python -m sapling_tpu_torch.tools.bench_nn_query <index.stpu.npz>
        [nq=5000000] [chunks=64] [size=16] [epochs=300] [stride=1]
        [iters=6] [device=cuda]

The artifact (SaplingIndex.save, e.g. of bench.py's 4.6 Mbp row:
SaplingIndex.build(benchmark_genome(4_600_000), IndexConfig(k=21,
buckets=22), device="cpu")) loads memory-mapped without the aligner's
run arrays;
`codes` is copied into RAM (the queries are cut from it at random). The
residual model trains and is audited on the device (models.serve
.train_serving, which prints its epochs and early-stopped chunks); both
engines' windows are printed, and the seconds of the audit alone (run
again). Then nq k-base genome substrings (seed 99) are prepared once as
device inputs (SaplingIndex.query_inputs) and each engine, the PWL table
first, is timed over them with CUDA events (utils.timing.timed: `iters`
calls a timing, three timings, median and spread printed); the full
position vector is then taken untimed, with the call's bisection rounds
(ops.query.ROUNDS, through stats=True), and a sample of 100,000 is
self-checked (SaplingIndex.verify_hits): a failure exits non-zero. The NN engine's
prediction (NNServing.predict_ranks) is also timed alone. The JAX tool's
data-chained loop with a digest was made for a remote TPU and is not
copied.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import parse_keyval_args
from ..index.sapling import SaplingIndex
from ..models.serve import NNQueryEngine, audit_serving, train_serving
from ..ops import query
from ..utils.timing import timed

N_CHECK = 100_000


def time_engine(tag: str, run, idx: SaplingIndex, codes2d: np.ndarray,
                iters: int, rng) -> float:
    """q/s of run() (one call over every query: median of 3 CUDA-event
    timings of `iters` calls), the bisection rounds of run(stats=True),
    and a self-check of a random sample; exits non-zero on a failed
    check."""
    nq = codes2d.shape[0]
    run()                                       # warm
    times = [timed(run, idx.device, reps=iters)[1] for _ in range(3)]
    dt = float(np.median(times))
    spread = 100.0 * (max(times) - min(times)) / dt
    query.ROUNDS.update(C=0, D=0)
    pos = run(stats=True).cpu().numpy()         # untimed
    sample = rng.choice(nq, min(nq, N_CHECK), replace=False)
    ok = int(idx.verify_hits(codes2d[sample], pos[sample]).sum())
    print(f"[{tag}] {nq/dt:,.0f} q/s ({dt*1e3:.3f} ms a call of {nq}; "
          f"median of 3, spread {spread:.1f}%, times_ms "
          f"{[round(s * 1e3, 3) for s in times]}; {query.ROUNDS['D']} "
          f"bisection rounds); self-check {ok}/{len(sample)}", flush=True)
    if ok != len(sample):
        raise SystemExit(f"[{tag}] self-check FAILED")
    return nq / dt


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    kv = parse_keyval_args(argv[2:])
    nq = int(kv.get("nq", 5_000_000))
    iters = int(kv.get("iters", 6))
    device = torch.device(kv.get("device", "cuda"))

    t0 = time.time()
    idx = SaplingIndex.load(argv[1], skip=("lcpk_fwd", "lcpk_bwd"),
                            mmap=True, device=device)
    idx.codes = np.array(idx.codes)
    print(f"loaded n={idx.n:,} 2^{idx.buckets} in {time.time()-t0:.1f}s",
          flush=True)
    t0 = time.time()
    srv = train_serving(idx, num_chunks=int(kv.get("chunks", 64)),
                        layer_size=int(kv.get("size", 16)),
                        epochs=int(kv.get("epochs", 300)),
                        sample_stride=int(kv.get("stride", 1)),
                        log=lambda m: print(m, flush=True))
    t = idx.table
    print(f"trained+audited on {device} in {time.time()-t0:.1f}s\n"
          f"  NN  windows: most=({srv.most_over},{srv.most_under}) "
          f"max=({srv.max_over},{srv.max_under})\n"
          f"  PWL windows: most=({t.most_over},{t.most_under}) "
          f"max=({t.max_over},{t.max_under})", flush=True)
    t0 = time.time()
    audit_serving(srv, idx)
    print(f"audit alone (every k-mer predicted on {device}): "
          f"{time.time()-t0:.1f}s", flush=True)

    K = idx.k
    rng = np.random.default_rng(99)
    starts = rng.integers(0, idx.n - K + 1, nq)
    codes2d = idx.codes[starts[:, None] + np.arange(K)]
    inputs = idx.query_inputs(codes2d)
    eng = NNQueryEngine(idx, srv)
    pwl_qps = time_engine(
        "PWL", lambda stats=False: idx.query_device(*inputs, K, stats=stats),
        idx, codes2d, iters, rng)
    nn_qps = time_engine(
        "NN", lambda stats=False: eng.query_device(*inputs, stats=stats),
        idx, codes2d, iters, rng)
    with torch.no_grad():
        pred_s = [timed(lambda: srv.predict_ranks(inputs[0]), idx.device,
                        reps=iters)[1] for _ in range(3)]
    print(f"[NN] of which predict_ranks: {np.median(pred_s)*1e3:.3f} ms a "
          f"call (median of 3, times_ms "
          f"{[round(s * 1e3, 3) for s in pred_s]})", flush=True)
    print(f"NN/PWL = {nn_qps/pwl_qps:.2f}x "
          f"({nn_qps:,.0f} vs {pwl_qps:,.0f} q/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
