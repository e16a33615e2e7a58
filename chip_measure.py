#!/usr/bin/env python3
"""Chip measurements of the PyTorch port on one GPU (the numbers in PERF.md).

    python3 chip_measure.py [out.json]

Run from the root of a checkout on a machine with one NVIDIA GPU, after
chip_smoke.py has shown the port right there: this script times, it does
not check results. It reuses chip_smoke.py's genome, indexes, SW batches
and queries (same seeds) and measures:

  sw:      the SW kernel against the plain PyTorch sw_pass, CUDA events, in
           turns (plain, kernel, kernel, plain), full and score-only, at
           the aligner's pair shape (W=100, R=128) for B=16,384 and for one
           block's candidate sweep (B=163,840);
  aligner: FASTQ -> SAM wall clock (host clock, after one warm block),
           three runs each of 20,000 and 100,000 reads with the default
           settings; one serial run of 20,000 reads (1 worker, no
           coalescing) with its phase seconds; one 20,000-read run under
           torch.profiler (device time by kernel);
  query:   query_device on 1,000,000 21-base queries, five CUDA-event
           timings; one profiled call (device kernels and their time);
           query_positions as a user calls it (host clock).

Prints one line per measurement and writes all of them, with the card's
name and power limit, as JSON to out.json (default
chiprun_out/measure.json). Exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import chip_smoke as cs

N_SWEEP = 163_840          # candidates of one 16,384-read aligner block
ALIGN_SIZES = (20_000, 100_000)
RUNS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def device_events(prof) -> dict:
    """{kernel name: [launches, device ms]} over the CUDA events of a
    torch.profiler run (kernels and copies; no host-side operator)."""
    out = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out[e.key] = [int(e.count), us / 1e3]
    return out


def _short(name: str) -> str:
    """'sw_pass_kernel<4, true>' out of a kernel's full signature."""
    i = name.find("sw_pass_kernel")
    return name[i:name.find(">", i) + 1]


def sw_times(dev) -> dict:
    """Kernel and plain sw_pass times in turns: plain, kernel, kernel,
    plain, per mode and batch size."""
    import torch

    from sapling_tpu_torch.ops.sw import sw_pass
    from sapling_tpu_torch.ops.sw_cuda import sw_pass_cuda

    out = {}
    for b in (cs.SW_BATCH, N_SWEEP):
        q, qlen, ref, rlen = cs.sw_batch(dev, b)
        no_term = torch.full((b,), -1, dtype=torch.int32, device=dev)
        for mode, so in (("full", False), ("score_only", True)):
            def kern():
                sw_pass_cuda(q, qlen, ref, rlen, no_term, score_only=so)

            def plain():
                sw_pass(q, qlen, ref, rlen, no_term, score_only=so)

            plain_ms = [cs._time_ms(plain, dev, reps=2, warm=1)]
            ms = [cs._time_ms(kern, dev), cs._time_ms(kern, dev)]
            plain_ms.append(cs._time_ms(plain, dev, reps=2, warm=1))
            gcups = [cs.SW_W * cs.SW_R * b / (t * 1e6) for t in ms]
            out[f"{mode}_B{b}"] = dict(ms=ms, plain_ms=plain_ms, gcups=gcups)
            log(f"sw {mode} B={b} W={cs.SW_W} R={cs.SW_R}: kernel "
                f"{ms[0]:.4f} / {ms[1]:.4f} ms ({gcups[0]:.1f} / "
                f"{gcups[1]:.1f} GCUPS), plain {plain_ms[0]:.3f} / "
                f"{plain_ms[1]:.3f} ms")
        del q, qlen, ref, rlen, no_term
        torch.cuda.empty_cache()
    return out


def aligner_times(dev, seq, idx16, workdir: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sapling_tpu_torch.align.aligner import SeedExtendAligner
    from sapling_tpu_torch.config import AlignerConfig
    from sapling_tpu_torch.io.fastq import read_fastq
    from sapling_tpu_torch.sim.genomes import simulate_reads, write_fastq

    didx = idx16.to(dev)
    reads, _pos, _rc = simulate_reads(seq, max(ALIGN_SIZES), cs.READ_LEN,
                                      sub_rate=0.01, seed=cs.SEED + 1)
    fqs = {}
    for n in ALIGN_SIZES:
        fqs[n] = os.path.join(workdir, f"reads{n}.fq")
        write_fastq(fqs[n], reads[:n])
    sam = os.path.join(workdir, "out.sam")
    aligner = SeedExtendAligner(didx, AlignerConfig(), device=dev)
    aligner.align_block(list(read_fastq(fqs[min(ALIGN_SIZES)]))[:1000])

    def run(n, **kw):
        t0 = time.perf_counter()
        aligner.align_fastq(fqs[n], sam, cl="chip_measure", **kw)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    out = {}
    for n in ALIGN_SIZES:
        secs = [run(n) for _ in range(RUNS)]
        out[f"reads{n}"] = dict(seconds=secs,
                                reads_per_s=[n / s for s in secs])
        log(f"aligner {n} reads: " + ", ".join(
            f"{s:.3f} s = {n / s:.1f} reads/s" for s in secs))

    n = min(ALIGN_SIZES)
    aligner.phase_seconds.clear()
    s = run(n, workers=1, coalesce=1)
    phases = dict(aligner.phase_seconds)
    out["serial"] = dict(reads=n, seconds=s, phases=phases)
    log(f"aligner serial (1 worker, no coalescing) {n} reads: {s:.3f} s; "
        "phases " + json.dumps({k: round(v, 4) for k, v in phases.items()}))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = run(n)
    ev = device_events(prof)
    busy = sum(ms for _c, ms in ev.values())
    sw_ev = {k: v for k, v in ev.items() if "sw_pass_kernel" in k}
    copy_ms = sum(ms for k, (_c, ms) in ev.items() if "Memcpy" in k)
    out["profile"] = dict(reads=n, seconds=s, device_ms=busy,
                          copy_ms=copy_ms, sw_kernels=sw_ev, events=ev)
    log(f"aligner profiled {n} reads: {s:.3f} s wall, device events "
        f"{busy:.3f} ms summed (device idle >= "
        f"{100 * (1 - busy / 1e3 / s):.2f}%), copies {copy_ms:.3f} ms, "
        "SW kernel "
        + json.dumps({_short(k): [c, round(ms, 4)]
                      for k, (c, ms) in sw_ev.items()}))
    return out


def query_times(dev, seq, idx21) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    length = cs.QUERY_LEN
    codes, _n_in = cs.query_codes(seq)
    didx = idx21.to(dev)
    x, q3 = didx.query_inputs(codes)
    ms = [cs._time_ms(lambda: didx.query_device(x, q3, length), dev,
                      reps=5, warm=1) for _ in range(5)]
    log(f"query_device {cs.N_QUERIES} queries: " + ", ".join(
        f"{t:.3f} ms = {cs.N_QUERIES / t / 1e3:.1f}M q/s" for t in ms))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        didx.query_device(x, q3, length)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    ev = device_events(prof)
    launches = sum(c for c, _ms in ev.values())
    busy = sum(ms for _c, ms in ev.values())
    log(f"query_device profiled: {wall * 1e3:.3f} ms wall, {launches} "
        f"device events, {busy:.3f} ms device time summed")

    host = []
    for _ in range(2):
        t0 = time.perf_counter()
        didx.query_positions(codes)
        host.append(time.perf_counter() - t0)
    log(f"query_positions {cs.N_QUERIES} queries (host packing + copies): "
        + ", ".join(f"{s:.3f} s = {cs.N_QUERIES / s:.1f} q/s" for s in host))
    return dict(query_device_ms=ms, profile=dict(
        wall_ms=wall * 1e3, device_events=launches, device_ms=busy,
        events=ev), query_positions_s=host)


def main(argv: list[str]) -> int:
    sys.path.insert(0, cs.ROOT)
    import torch

    from sapling_tpu_torch.ops import sw_cuda

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    out_path = argv[0] if argv else os.path.join(
        cs.ROOT, "chiprun_out", "measure.json")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    seq, idx16, idx21 = cs.build_indexes(cs.GENOME_N)   # before CUDA starts
    sw_cuda.build_kernel()
    dev = torch.device("cuda", 0)
    res = dict(card=smi, torch=torch.__version__, cuda=torch.version.cuda,
               sw=sw_times(dev))
    with tempfile.TemporaryDirectory(prefix="chip_measure_") as td:
        res["aligner"] = aligner_times(dev, seq, idx16, td)
    res["query"] = query_times(dev, seq, idx21)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    log(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
