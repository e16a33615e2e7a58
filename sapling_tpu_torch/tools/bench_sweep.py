"""Multi-configuration benchmark sweep (PyTorch port; the twin of
tools/bench_sweep.py).

Measures the reference's published experiment axes (the reference
hard-codes its results into plotting scripts, eval/TimingPlot/plot.py
etc.):

  * genome-size sweep (4.6 Mbp E. coli scale ... 230 Mbp chr1 scale ...)
  * query-length sweep (11/21/31/41/51/101, eval/VarQuery) at the
    largest size
  * PWL against the binary-search baseline
  * index memory per size (eval/Memory), and the bytes the port keeps on
    the device

    python -m sapling_tpu_torch.tools.bench_sweep
        [sizes=4600000,46000000,230000000] [nq=5000000]
        [out=.bench_cache/sweep] [cache=.bench_cache] [device=cuda]

Each size is sim.genomes.benchmark_genome(n), indexed with
SaplingIndex.build(IndexConfig(k=21)) (automatic buckets, prefix arrays:
the fast3 path) and cached as <cache>/bench_<n>_k21.stpu.npz (a file of
that name is loaded as it is). Times are CUDA events around
SaplingIndex.query_device / binsearch_device on prepared inputs
(utils.timing.timed); 100,000 sampled positions are self-checked and,
at lengths >= k, must all verify. Writes <out>/results.json, then the
JAX tool's three plots (timing.png, memory.png, query_length.png,
evalx/plots.py). The plots need matplotlib: where it is not installed,
the last line says so and the tool still succeeds (the results are
written first).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..config import IndexConfig, parse_keyval_args
from ..evalx.memory import index_memory_report
from ..index.sapling import SaplingIndex
from ..sim.genomes import benchmark_genome
from ..utils.timing import timed
from .build_big_index import CACHE

SWEEP = (11, 21, 31, 41, 51, 101)


def measure(idx: SaplingIndex, qlen: int, nq: int, baseline: bool = False,
            reps: int = 6) -> dict:
    """plquery q/s at one length on `idx` (an index on its query device):
    `reps` timed calls after a warm one; with `baseline`, also the plain
    binary search over the first min(nq, 1M) queries."""
    rng = np.random.default_rng(99)
    starts = rng.integers(0, idx.n - qlen + 1, nq)
    codes2d = idx.codes[starts[:, None] + np.arange(qlen)]
    inputs = idx.query_inputs(codes2d)

    def run():
        return idx.query_device(*inputs, qlen)

    pos, dt = timed(run, idx.device, reps=reps, warm=1)
    sample = np.random.default_rng(1).choice(nq, min(nq, 100_000), False)
    good = int(idx.verify_hits(codes2d[sample],
                               pos.cpu().numpy()[sample]).sum())
    if qlen >= idx.k and good != len(sample):
        raise SystemExit(f"self-check {good}/{len(sample)} at qLen={qlen}")
    res = {"qlen": qlen, "nq": nq, "plquery_qps": round(nq / dt),
           "plquery_ms": dt * 1e3, "self_check": f"{good}/{len(sample)}"}
    if baseline:
        nb = min(nq, 1_000_000)
        qw = (inputs[2][:, :nb] if inputs[2] is not None
              else idx.query_words(codes2d[:nb]))
        bpos, bdt = timed(lambda: idx.binsearch_device(qw, qlen),
                          idx.device, reps=3, warm=1)
        bgood = int(idx.verify_hits(codes2d[:nb], bpos.cpu().numpy()).sum())
        if bgood != nb:
            raise SystemExit(f"binary search self-check {bgood}/{nb}")
        res.update(binsearch_qps=round(nb / bdt), binsearch_ms=bdt * 1e3)
    return res


def main(argv):
    kv = parse_keyval_args(argv[1:])
    sizes = [int(s) for s in kv.get("sizes", "4600000,46000000").split(",")]
    nq = int(kv.get("nq", 5_000_000))
    cache = kv.get("cache", CACHE)
    out_dir = kv.get("out", os.path.join(CACHE, "sweep"))
    device = torch.device(kv.get("device", "cuda"))
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(cache, exist_ok=True)

    results = {"device": str(device), "sizes": [], "qlen_sweep": None}
    if device.type == "cuda":
        results["device_name"] = torch.cuda.get_device_name(device)
    for n in sizes:
        npz = os.path.join(cache, f"bench_{n}_k21.stpu.npz")
        t0 = time.time()
        if os.path.exists(npz):
            idx = SaplingIndex.load(npz, device=device)
        else:
            idx = SaplingIndex.build(benchmark_genome(n), IndexConfig(k=21),
                                     device=device)
            idx.save(npz)
        build_s = time.time() - t0
        r = measure(idx, 21, nq, baseline=True)
        r.update(n=n, buckets=idx.buckets, build_or_load_s=round(build_s, 1),
                 device_bytes=idx.device_bytes(),
                 memory=index_memory_report(idx))
        results["sizes"].append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "memory"}),
              flush=True)
        if n == sizes[-1]:
            sweep = []
            for ql in SWEEP:
                sweep.append(measure(idx, ql, nq))
                print(json.dumps(sweep[-1]), flush=True)
            results["qlen_sweep"] = {"n": n, "points": sweep}
        del idx

    path = os.path.join(out_dir, "results.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    try:
        from ..evalx import plots
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        print(f"wrote {path}; no plots: matplotlib is not installed")
        return 0
    ns = [r["n"] for r in results["sizes"]]
    plots.timing_plot(
        ns,
        {f"port ({device.type})": [r["plquery_qps"]
                                   for r in results["sizes"]],
         f"binary search ({device.type})": [r["binsearch_qps"]
                                            for r in results["sizes"]]},
        os.path.join(out_dir, "timing.png"))
    plots.memory_plot(
        [f"{r['n']/1e6:.0f}Mbp" for r in results["sizes"]],
        [r["memory"]["total_bytes"] / 1e9 for r in results["sizes"]],
        os.path.join(out_dir, "memory.png"))
    pts = results["qlen_sweep"]["points"]
    plots.query_length_plot(
        [p["qlen"] for p in pts],
        {f"port ({device.type})": [p["plquery_qps"] for p in pts]},
        os.path.join(out_dir, "query_length.png"))
    print(f"wrote {path} + plots")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
