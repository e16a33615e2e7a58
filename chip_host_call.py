"""The host time of one plQuery request on the card: `plquery_cuda` (every
array checked a call) against a launch plan's request
(sapling_tpu_torch/ops/query_cuda.py `PlqueryPlan`) and `query_device`.

    python3 chip_host_call.py [out.json] [--reps=200] [--lanes=5000000]
                              [--waits=0,0.7]

Builds a 4.6 Mbp k=21 index on the host (`benchmark_genome`, no prefix
arrays: the benchmark's E. coli size and form), puts it on the card and
prepares one batch of `lanes` queries at each of L = 21, 31, 41, 51 and
101. It sends them as the benchmark sends its requests (one in flight: the
host clock read around the call, then a CUDA event recorded and waited on;
the thread on one core, the collector off), in blocks of 25 requests, one
block of each case in turn, `reps` x 5 requests a case (a block's first
request, after another case's, is dropped). Cases: each path on the
index's own arrays (rev and the genome) and on rank records made of them
(the probes of an index past the L2), the five lengths in turn or L = 101
alone (on rank records one probe form, as on the genome, against two
kernel instances in turn), and a wait of each of `waits` ms more on the
card after each call (a spin kernel before the event), which lengthens the
host's wait as a slower kernel would. Prints each case's median and mean
host time in us and its median latency in ms, and writes them with the
card's name and power limit to out.json (default
chiprun_out/host_call.json). Exits non-zero without a GPU.
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from sapling_tpu_torch.config import IndexConfig, QueryConfig
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.ops import query_cuda as qc
from sapling_tpu_torch.sim.genomes import benchmark_genome

LENGTHS = (21, 31, 41, 51, 101)
BLOCK = 25
SM_HZ = 1.98e9   # the H100's max SM clock: a spin kernel's cycles a second


def queries(seq, num, length, seed):
    """7/8 genome substrings at uniform positions, 1/8 random bases."""
    rng = np.random.default_rng(seed)
    absent = num // 8
    pos = rng.integers(0, len(seq) - length + 1, num - absent)
    q = np.concatenate([packops.encode_bases(seq)[pos[:, None]
                                                  + np.arange(length)],
                        rng.integers(0, 4, (absent, length), dtype=np.uint8)])
    return q[rng.permutation(num)]


def paths(idx, rank_recs):
    """{path: call(x, q3, q_words, length)} on idx's arrays, reading
    rank_recs (None: rev and the genome, query_device's form here)."""
    d = idx.device_arrays()
    bucket_recs = idx.query_records()[0]
    kw = idx._query_kw(QueryConfig(), bucket_recs, rank_recs)
    plan = qc.PlqueryPlan(d["packed"], d["rev"], d["xlist"], d["ylist"],
                          d["prefix3"], d["bounds"], **kw)
    out = {
        "plquery_cuda": lambda x, q3, qw, length: qc.plquery_cuda(
            d["packed"], d["rev"], d["xlist"], d["ylist"], qw, x,
            d["prefix64"], d["prefix3"], q3, d["bounds"], length=length,
            **kw),
        "plan": lambda x, q3, qw, length: plan(x, qw, q3, length)}
    if rank_recs is None:
        out["query_device"] = idx.query_device
    return out


def measure(cases: dict, inputs: dict, reps: int) -> dict:
    """{case: host us and latency ms} of cases {name: (call, lengths,
    wait ms)}, one block of each in turn."""
    end = torch.cuda.Event()
    host = {name: [] for name in cases}
    latency = {name: [] for name in cases}
    for call, lengths, _ in cases.values():   # warm: allocator blocks
        for length in lengths:
            call(*inputs[length], length)
    torch.cuda.synchronize()
    for _ in range(reps * len(LENGTHS) // BLOCK):
        for name, (call, lengths, wait) in cases.items():
            cycles = int(wait * 1e-3 * SM_HZ)
            for i, length in zip(range(BLOCK), itertools.cycle(lengths)):
                args = inputs[length]
                h0 = time.perf_counter()
                out = call(*args, length)
                h1 = time.perf_counter()
                if cycles:
                    torch.cuda._sleep(cycles)
                end.record()
                end.synchronize()
                if i:
                    host[name].append((h1 - h0) * 1e6)
                    latency[name].append((time.perf_counter() - h0) * 1e3)
                del out
    return {name: dict(host_median_us=statistics.median(host[name]),
                       host_mean_us=statistics.mean(host[name]),
                       latency_median_ms=statistics.median(latency[name]))
            for name in cases}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_host_call.py: no CUDA device", file=sys.stderr)
        return 1
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--"))
    args = [a for a in argv if not a.startswith("--")]
    out_path = args[0] if args else os.path.join("chiprun_out",
                                                 "host_call.json")
    reps, lanes = int(opts.get("reps", 200)), int(opts.get("lanes", 5_000_000))
    waits = [float(w) for w in opts.get("waits", "0,0.7").split(",")]
    seq = benchmark_genome(4_600_000, seed=22)
    idx = SaplingIndex.build(seq, IndexConfig(k=21, prefix_lookup=False),
                             keep_aligner_arrays=False,
                             device="cpu").to("cuda")
    inputs = {length: idx.query_inputs(queries(seq, lanes, length,
                                               seed=length))
              for length in LENGTHS}
    d = idx.device_arrays()
    ranks = qc.plquery_records_cuda(d["packed"], d["rev"], n=idx.n)
    cases = {}
    for form, rank_recs in (("genome", None), ("ranks", ranks)):
        for path, call in paths(idx, rank_recs).items():
            for order, lengths in (("in turn", LENGTHS), ("L=101", (101,))):
                for wait in waits:
                    cases[f"{form} / {path} / {order} / +{wait} ms"] = (
                        call, lengths, wait)
    cpus = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cpus)})
    gc.collect()
    gc.disable()
    try:
        result = dict(card=card(), reps=reps, lanes=lanes,
                      cases=measure(cases, inputs, reps))
    finally:
        gc.enable()
        os.sched_setaffinity(0, cpus)
    for name, r in result["cases"].items():
        print(f"{name}: {json.dumps(r)}", flush=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"card: {result['card']}; wrote {out_path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
