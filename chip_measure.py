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
           query_positions as a user calls it (host clock);
  sweep:   chip_smoke.py's length sweep (11 ... 101) on the k=21 index as
           built and without prefix arrays, three CUDA-event timings each,
           and one profiled call per index at lengths 21 and 101;
  baselines: the plain and the llcp/rlcp-pruned binary search on the
           21-base queries, three timings and one profiled call each.

Profiled calls also give the device's busy share within their own
window. Prints one line per measurement and writes all of them, with the
card's name, power limit and UUID and the host's name, as JSON to
out.json (default
chiprun_out/measure.json). Exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import os
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


def profiled(fn, dev) -> dict:
    """One call of fn under torch.profiler: host wall ms, the number of
    device events (kernels, copies, memsets), their summed ms, and `busy`,
    that sum over the wall time of the same profiled call (the profiler
    slows the host side, so this is a floor of the unprofiled share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    ev = device_events(prof)
    busy_ms = sum(ms for _c, ms in ev.values())
    return dict(wall_ms=wall * 1e3,
                device_events=sum(c for c, _ms in ev.values()),
                device_ms=busy_ms, busy=busy_ms / (wall * 1e3), events=ev)


def query_times(dev, seq, idx21) -> dict:
    length = cs.QUERY_LEN
    codes, _n_in = cs.query_codes(seq)
    didx = idx21.to(dev)
    inputs = didx.query_inputs(codes)
    ms = [cs._time_ms(lambda: didx.query_device(*inputs, length), dev,
                      reps=5, warm=1) for _ in range(5)]
    log(f"query_device {cs.N_QUERIES} queries: " + ", ".join(
        f"{t:.3f} ms = {cs.N_QUERIES / t / 1e3:.1f}M q/s" for t in ms))

    prof = profiled(lambda: didx.query_device(*inputs, length), dev)
    wall, launches, busy = (prof["wall_ms"] / 1e3, prof["device_events"],
                            prof["device_ms"])
    log(f"query_device profiled: {wall * 1e3:.3f} ms wall, {launches} "
        f"device events, {busy:.3f} ms device time summed "
        f"({100 * prof['busy']:.1f}% busy)")

    host = []
    for _ in range(2):
        t0 = time.perf_counter()
        didx.query_positions(codes)
        host.append(time.perf_counter() - t0)
    log(f"query_positions {cs.N_QUERIES} queries (host packing + copies): "
        + ", ".join(f"{s:.3f} s = {cs.N_QUERIES / s:.1f} q/s" for s in host))
    return dict(query_device_ms=ms, profile=prof, query_positions_s=host)


def sweep_times(dev, seq, idx21) -> list[dict]:
    """The length sweep on both indexes; profiled at lengths 21 and 101."""
    from sapling_tpu_torch.ops import query

    rows = []
    for length in cs.SWEEP:
        codes, _n_in = cs.query_codes(seq, length)
        row = dict(length=length)
        for name, idx in (("built", idx21),
                          ("no_prefix", cs.without_prefix(idx21))):
            didx = idx.to(dev)
            inputs = didx.query_inputs(codes)
            query.ROUNDS.update(C=0, D=0)
            didx.query_device(*inputs, length)
            r = dict(form=cs._probe_form(idx, length),
                     rounds=dict(query.ROUNDS),
                     ms=[cs._time_ms(lambda: didx.query_device(
                         *inputs, length), dev, reps=3, warm=1)
                         for _ in range(3)])
            r["qps"] = [cs.N_QUERIES / (t / 1e3) for t in r["ms"]]
            if length in (21, 101):
                r["profile"] = profiled(
                    lambda: didx.query_device(*inputs, length), dev)
            row[name] = r
            log(f"sweep L={length} {name} ({r['form']}): " + ", ".join(
                f"{t:.3f} ms" for t in r["ms"])
                + f" = {max(r['qps']) / 1e6:.2f}M q/s best; rounds "
                f"{r['rounds']}" + (
                    f"; profiled {r['profile']['device_events']} device "
                    f"events, {r['profile']['device_ms']:.3f} ms device "
                    f"time, {r['profile']['wall_ms']:.3f} ms wall "
                    f"({100 * r['profile']['busy']:.1f}% busy)"
                    if "profile" in r else ""))
            del inputs, didx
        rows.append(row)
    return rows


def baseline_times(dev, seq, idx21, tables) -> dict:
    codes, _n_in = cs.query_codes(seq)
    out = {}
    for name, fn in cs.baseline_runs(idx21.to(dev), codes, tables).items():
        ms = [cs._time_ms(fn, dev, reps=3, warm=1) for _ in range(3)]
        prof = profiled(fn, dev)
        out[name] = dict(ms=ms, qps=[cs.N_QUERIES / (t / 1e3) for t in ms],
                         profile=prof)
        log(f"{name} {cs.N_QUERIES} queries: " + ", ".join(
            f"{t:.3f} ms" for t in ms) + f"; profiled "
            f"{prof['device_events']} device events, "
            f"{prof['device_ms']:.3f} ms device time, "
            f"{prof['wall_ms']:.3f} ms wall ({100 * prof['busy']:.1f}% busy)")
    return out


def main(argv: list[str]) -> int:
    sys.path.insert(0, cs.ROOT)
    import torch

    from sapling_tpu_torch.ops import sw_cuda

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    out_path = argv[0] if argv else os.path.join(
        cs.ROOT, "chiprun_out", "measure.json")
    info = cs.card()
    log(f"card: {info['name_power']}, {info['uuid']} on host "
        f"{info['host']}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    seq, idx16, idx21, tables = cs.build_indexes(cs.GENOME_N)  # before CUDA
    sw_cuda.build_kernel()
    dev = torch.device("cuda", 0)
    res = dict(card=info, torch=torch.__version__, cuda=torch.version.cuda,
               sw=sw_times(dev))
    with tempfile.TemporaryDirectory(prefix="chip_measure_") as td:
        res["aligner"] = aligner_times(dev, seq, idx16, td)
    res["query"] = query_times(dev, seq, idx21)
    res["sweep"] = sweep_times(dev, seq, idx21)
    res["baselines"] = baseline_times(dev, seq, idx21, tables)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    log(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
