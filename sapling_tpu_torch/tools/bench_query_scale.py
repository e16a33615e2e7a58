"""Query-throughput benchmark for any saved index artifact (PyTorch port;
the twin of tools/bench_query_scale.py).

    python -m sapling_tpu_torch.tools.bench_query_scale <index.stpu.npz>
        [nq=5000000] [qLen=21[,31,...]] [iters=10] [adaptive=0]
        [hitrate=0] [table=<table.npz> [ab=0]] [device=cuda]

The artifact loads memory-mapped without the members a query never reads
(inv, inv_hi, lcpk_fwd, lcpk_bwd); `codes` is copied into RAM, because
the queries are cut from it at random and a cold map page-faults. For
each length it draws nq genome substrings (seed 99), prepares the device
inputs once (SaplingIndex.query_inputs), and times
SaplingIndex.query_device over them with CUDA events
(utils.timing.timed, `iters` calls a timing, three timings: the median
and the spread are printed). The full position vector is then taken
untimed and its first 200,000 positions are self-checked
(SaplingIndex.verify_hits); at lengths >= k a failure exits non-zero
(below k the reference's algorithm does not promise every hit, and the
count is only printed). Each length also prints the peak device memory
of its calls (torch.cuda.max_memory_allocated) and the bytes of the
index's device arrays (SaplingIndex.device_bytes).

Each length also prints the rounds of the untimed call (ops.query.ROUNDS:
bisection rounds, stride steps; on the card the kernel's deepest phase D
and phase C step counts, read with stats=True, which equal the plain
cascade's host loop rounds). hitrate=1 first
counts the queries whose predicted rank already matches (the prediction
probe: ops.predict.predict_pwl, then one ops.query.make_rank_probe).
table= swaps in a retabled PWL table
(sapling_tpu_torch.tools.retable_index) through SaplingIndex.swap_table;
with ab=1 the artifact's own table runs first and the other table after
it, on the same rev and packed tensors. adaptive=1 uses the per-bucket
bounds (QueryConfig.adaptive_bounds).

The JAX tool's compact=, compact_u=, cap=, sweep= and rows2d= select TPU
batch compaction and TPU rank layouts, which the port does not have
(they never change a result): they are refused. Its chained-loop digest
timing was made for a remote TPU and is not copied.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..config import QueryConfig, parse_keyval_args
from ..index.sapling import SaplingIndex
from ..ops import query
from ..ops.predict import predict_pwl
from ..utils.timing import timed
from .retable_index import load_table

QUERY_SKIP = ("inv", "inv_hi", "lcpk_fwd", "lcpk_bwd")
TPU_ONLY = ("compact", "compact_u", "cap", "sweep", "rows2d")
N_CHECK = 200_000


def load_for_queries(path: str, device) -> SaplingIndex:
    """The artifact, memory-mapped without the members a query never
    reads, with `codes` copied into RAM."""
    idx = SaplingIndex.load(path, skip=QUERY_SKIP, mmap=True, device=device)
    idx.codes = np.array(idx.codes)
    return idx


def memory_line(idx: SaplingIndex) -> str:
    """The index's device bytes and the peak device memory since the last
    torch.cuda.reset_peak_memory_stats."""
    dev = f"index on {idx.device}: {idx.device_bytes() / 1e9:.3f} GB"
    if idx.device.type != "cuda":
        return dev + "; peak device memory not measured (not a card)"
    peak = torch.cuda.max_memory_allocated(idx.device)
    return dev + f"; peak device memory {peak / 1e9:.3f} GB"


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    kv = parse_keyval_args(argv[2:])
    refused = [f for f in TPU_ONLY if f in kv]
    if refused:
        raise SystemExit(
            f"{', '.join(f + '=' for f in refused)}: TPU batch compaction "
            "and TPU rank layouts, which the port does not have (they "
            "never change a result)")
    nq = int(kv.get("nq", 5_000_000))
    qlens = [int(v) for v in str(kv.get("qLen", "21")).split(",")]
    iters = int(kv.get("iters", 10))
    qcfg = QueryConfig(adaptive_bounds=bool(int(kv.get("adaptive", 0))))
    want_hitrate = bool(int(kv.get("hitrate", 0)))
    device = torch.device(kv.get("device", "cuda"))

    t0 = time.time()
    idx = load_for_queries(argv[1], device)
    over_table = None
    if "table" in kv:
        over_table = load_table(kv["table"], idx.n, idx.k)
        if not int(kv.get("ab", 0)):
            idx.swap_table(over_table)
            over_table = None
            print(f"table override: 2^{idx.buckets} buckets from "
                  f"{kv['table']}", flush=True)
    t = idx.table
    print(f"loaded n={idx.n:,} buckets=2^{idx.buckets} "
          f"most=({t.most_over},{t.most_under}) "
          f"max=({t.max_over},{t.max_under}) in {time.time()-t0:.1f}s",
          flush=True)
    t0 = time.time()
    idx.device_arrays()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"device arrays on {device} in {time.time()-t0:.1f}s; "
          f"{memory_line(idx)}", flush=True)
    if qcfg.adaptive_bounds and idx.device_arrays()["bounds"] is None:
        raise SystemExit("adaptive=1 needs an index with bounds (rebuild "
                         "with bounds=1, or add_bucket_bounds)")

    results = {ql: bench_len(idx, ql, nq, iters, qcfg, want_hitrate)
               for ql in qlens}
    if len(qlens) > 1:
        print("qLen sweep: " + "  ".join(
            f"{ql}:{qps:,.0f}" for ql, qps in results.items()))
    if over_table is not None:
        idx.swap_table(over_table)
        print(f"--- A/B: swapped to 2^{idx.buckets} buckets from "
              f"{kv['table']} (rev/packed stay resident)", flush=True)
        results_b = {ql: bench_len(idx, ql, nq, iters, qcfg, want_hitrate)
                     for ql in qlens}
        for ql in qlens:
            print(f"A/B qLen={ql}: base {results[ql]:,.0f} vs "
                  f"2^{idx.buckets} {results_b[ql]:,.0f} "
                  f"({results_b[ql]/results[ql]:.2f}x)")
    return 0


def hit_rate(idx: SaplingIndex, codes2d: np.ndarray, x, q_words) -> int:
    """Queries whose predicted rank's suffix already matches."""
    dev = idx.device_arrays()
    length = int(codes2d.shape[1])
    if q_words is None:
        q_words = idx.query_words(codes2d)
    pred = predict_pwl(x, dev["xlist"], dev["ylist"], 2 * idx.k,
                       idx.buckets, idx.n)
    probe = query.make_rank_probe(dev["packed"], dev["rev"],
                                  dev["prefix64"], q_words, n=idx.n,
                                  length=length)
    return int(probe(pred)[1].match.sum())


def bench_len(idx: SaplingIndex, qlen: int, nq: int, iters: int,
              qcfg: QueryConfig, want_hitrate: bool) -> float:
    """One query length: q/s (median of 3 timings), after a self-check."""
    rng = np.random.default_rng(99)
    starts = rng.integers(0, idx.n - qlen + 1, nq)
    codes2d = idx.codes[starts[:, None] + np.arange(qlen)]
    x, q3, q_words = idx.query_inputs(codes2d)
    if want_hitrate:
        hits = hit_rate(idx, codes2d, x, q_words)
        print(f"prediction-probe hit rate: {hits}/{nq} ({hits/nq:.1%}); "
              f"unresolved {nq-hits} ({(nq-hits)/nq:.1%})", flush=True)
    if idx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(idx.device)

    def run(stats=False):
        return idx.query_device(x, q3, q_words, qlen, qcfg, stats=stats)

    run()                                       # warm
    times = [timed(run, idx.device, reps=iters)[1] for _ in range(3)]
    dt = float(np.median(times))
    spread = 100.0 * (max(times) - min(times)) / dt
    query.ROUNDS.update(C=0, D=0)
    pos = run(stats=True).cpu().numpy()         # untimed
    sample = min(nq, N_CHECK)
    ok = int(idx.verify_hits(codes2d[:sample], pos[:sample]).sum())
    print(f"plquery qLen={qlen} fast3={q3 is not None} on {idx.device}: "
          f"{nq/dt:,.0f} q/s ({dt*1e3:.3f} ms a call of {nq}; median of 3,"
          f" spread {spread:.1f}%, times_ms "
          f"{[round(s * 1e3, 3) for s in times]}; {query.ROUNDS['D']} "
          f"bisection rounds, {query.ROUNDS['C']} stride steps); self-check "
          f"{ok}/{sample}; {memory_line(idx)}", flush=True)
    if ok != sample and qlen >= idx.k:
        raise SystemExit("self-check FAILED")
    return nq / dt


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
