#!/usr/bin/env python3
"""Chip measurements of the PyTorch port on one GPU (the numbers in PERF.md).

    python3 chip_measure.py [out.json] [--against=path/to/other/sw.cu]

Run from the root of a checkout on a machine with one NVIDIA GPU, after
chip_smoke.py has shown the port right there: this script times, it does
not check results. It reuses chip_smoke.py's genome, indexes, SW batches
and queries (same seeds) and measures:

  sw:      the SW kernels against the plain PyTorch sw_pass, CUDA events, in
           turns (plain, kernel, kernel, plain), full and score-only, at
           the aligner's pair shape (W=100, R=128) for B=16,384 and for one
           block's candidate sweep (B=163,840), each beside its bound
           (chip_smoke.sw_bound_ms at the card's maximum SM clock); with
           --against, the score-only launch of another version of
           csrc/sw.cu (same C entry point, built with the same flags) in
           turns with this one (other, this, this, other), its scores
           held equal; and the step loop of the score-only kernel at
           W=100 in the SASS of this build (cuobjdump): its instructions
           by opcode;
  aligner: FASTQ -> SAM wall clock (host clock, after one warm block),
           three runs each of 20,000 and 100,000 reads with the default
           settings; one serial run of 20,000 reads (1 worker, no
           coalescing) with its phase seconds; one 20,000-read run under
           torch.profiler (device time by kernel); the score-only sweep's
           own launches of one 20,000-read run, recorded and launched
           again alone, each beside its bound;
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

N_SWEEP = cs.SW_SWEEP      # candidates of one 16,384-read aligner block
# the score-only kernel the aligner's W=100 (pad 16) launches, and the DP
# cells a lane computes in a trip of its step loop (two steps of S=14 rows)
SASS_KERNEL, SASS_CELLS = "sw_kernelILi8ELi14ELb0EE", 28
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
    """'sw_kernel<8, 14, false>' out of a kernel's full signature."""
    i = name.find("sw_")
    return name[i:name.find(">", i) + 1]


def sass_step_loop(lib_path: str) -> dict:
    """The step loop of SASS_KERNEL in `cuobjdump -sass lib_path`: its
    longest loop (a backward branch and the instructions from its target
    to it). Returns {"instructions", "per_cell" (over SASS_CELLS),
    "opcodes": {mnemonic with its modifiers: count}}."""
    import collections
    import re
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib_path],
        capture_output=True, text=True, check=True).stdout
    func = next(f for f in re.split(r"\n\s*Function : ", sass)[1:]
                if SASS_KERNEL in f.split("\n", 1)[0])
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
    loop = []
    for at, text in ins:
        m = re.search(r"BRA\s+(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < at:
            loop = max(loop, [t for a, t in ins
                              if int(m.group(1), 16) <= a <= at], key=len)
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
                              for t in loop)
    return dict(instructions=len(loop), per_cell=len(loop) / SASS_CELLS,
                opcodes=dict(ops.most_common()))


def with_lib(lib, fn):
    """fn() with sw_cuda's launches going to the library `lib`."""
    from sapling_tpu_torch.ops import sw_cuda

    saved, sw_cuda._LIB = sw_cuda._LIB, lib
    try:
        return fn()
    finally:
        sw_cuda._LIB = saved


def sw_times(dev, sm_clock_mhz: float, against: str | None = None) -> dict:
    """Kernel and plain sw_pass times in turns: plain, kernel, kernel,
    plain, per mode and batch size, each beside its bound; with `against`
    (another sw.cu with the same C entry point), its score-only kernel in
    turns with this one."""
    import torch

    from sapling_tpu_torch.ops import sw_cuda
    from sapling_tpu_torch.ops.sw import sw_pass
    from sapling_tpu_torch.ops.sw_cuda import sw_pass_cuda

    other = sw_cuda.bind(sw_cuda.build_kernel(against)) if against else None
    out = {}
    for b in (cs.SW_BATCH, N_SWEEP):
        q, qlen, ref, rlen = cs.sw_batch(dev, b)
        no_term = torch.full((b,), -1, dtype=torch.int32, device=dev)
        for mode, so in (("full", False), ("score_only", True)):
            def kern():
                return sw_pass_cuda(q, qlen, ref, rlen, no_term,
                                    score_only=so)

            def plain():
                sw_pass(q, qlen, ref, rlen, no_term, score_only=so)

            plain_ms = [cs._time_ms(plain, dev, reps=2, warm=1)]
            ms = [cs._time_ms(kern, dev), cs._time_ms(kern, dev)]
            plain_ms.append(cs._time_ms(plain, dev, reps=2, warm=1))
            bound = cs.sw_bound_ms(qlen, rlen, cs.SW_W, cs.SW_R,
                                   1 if so else 5, sm_clock_mhz)
            gcups = [bound["cells"] / (t * 1e6) for t in ms]
            row = dict(ms=ms, plain_ms=plain_ms, gcups=gcups, **bound,
                       pct_of_bound=[100 * bound["bound_ms"] / t
                                     for t in ms])
            log(f"sw {mode} B={b} W={cs.SW_W} R={cs.SW_R}: kernel "
                f"{ms[0]:.4f} / {ms[1]:.4f} ms ({gcups[0]:.1f} / "
                f"{gcups[1]:.1f} GCUPS over {bound['cells']} real cells), "
                f"plain {plain_ms[0]:.3f} / {plain_ms[1]:.3f} ms; bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}): "
                f"{row['pct_of_bound'][0]:.1f} / "
                f"{row['pct_of_bound'][1]:.1f}% of it")
            if so and other:
                def theirs():
                    return with_lib(other, kern)

                if not torch.equal(theirs()["score"], kern()["score"]):
                    raise AssertionError(f"{against} disagrees at B={b}")
                t_other = [cs._time_ms(theirs, dev)]
                t_this = [cs._time_ms(kern, dev), cs._time_ms(kern, dev)]
                t_other.append(cs._time_ms(theirs, dev))
                row["against"] = dict(source=against, ms=t_other,
                                      this_ms=t_this)
                log(f"sw score_only B={b}: {against} {t_other[0]:.4f} / "
                    f"{t_other[1]:.4f} ms in turns with this tree's "
                    f"{t_this[0]:.4f} / {t_this[1]:.4f} ms (scores equal)")
            out[f"{mode}_B{b}"] = row
        del q, qlen, ref, rlen, no_term
        torch.cuda.empty_cache()
    out["sass"] = sass_step_loop(sw_cuda.build_kernel())
    log(f"sass {SASS_KERNEL} step loop: {out['sass']['instructions']} "
        f"instructions for {SASS_CELLS} cells "
        f"({out['sass']['per_cell']:.2f} a cell); "
        + json.dumps(out["sass"]["opcodes"]))
    return out


def aligner_sweep(dev, aligner, fq: str, sam: str,
                  sm_clock_mhz: float) -> list[dict]:
    """The aligner's own score-only sweep: the inputs of every score-only
    launch of one align_fastq run over `fq`, each launched again alone
    (CUDA events) and held against its bound."""
    from sapling_tpu_torch.ops import sw, sw_cuda

    calls = []

    def record(q, qlen, ref, rlen, term, **kw):
        if kw.get("score_only"):
            calls.append(([t.clone() for t in (q, qlen, ref, rlen, term)],
                          kw))
        return sw_cuda.sw_pass_cuda(q, qlen, ref, rlen, term, **kw)

    sw.sw_pass_cuda = record
    try:
        aligner.align_fastq(fq, sam, cl="chip_measure")
    finally:
        sw.sw_pass_cuda = sw_cuda.sw_pass_cuda
    rows = []
    for args, kw in calls:
        q, qlen, ref, rlen, _term = args
        ms = cs._time_ms(lambda: sw_cuda.sw_pass_cuda(*args, **kw), dev)
        bound = cs.sw_bound_ms(qlen, rlen, q.shape[1], ref.shape[1], 1,
                               sm_clock_mhz)
        row = dict(pairs=q.shape[0], w=q.shape[1], r=ref.shape[1],
                   pad_to=kw.get("pad_to"),
                   mean_qlen=float(qlen.float().mean()),
                   mean_rlen=float(rlen.float().mean()), ms=ms, **bound,
                   pct_of_bound=100 * bound["bound_ms"] / ms)
        rows.append(row)
        log(f"aligner sweep launch: {row['pairs']} pairs, W={row['w']} "
            f"R={row['r']} pad {row['pad_to']}, mean qlen "
            f"{row['mean_qlen']:.2f} rlen {row['mean_rlen']:.2f}, "
            f"{row['cells']} real cells: {ms:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['pct_of_bound']:.1f}% of it)")
    return rows


def aligner_times(dev, seq, idx16, workdir: str,
                  sm_clock_mhz: float) -> dict:
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
    sw_ev = {k: v for k, v in ev.items()
             if "sw_kernel" in k}
    copy_ms = sum(ms for k, (_c, ms) in ev.items() if "Memcpy" in k)
    out["profile"] = dict(reads=n, seconds=s, device_ms=busy,
                          copy_ms=copy_ms, sw_kernels=sw_ev, events=ev)
    log(f"aligner profiled {n} reads: {s:.3f} s wall, device events "
        f"{busy:.3f} ms summed (device idle >= "
        f"{100 * (1 - busy / 1e3 / s):.2f}%), copies {copy_ms:.3f} ms, "
        "SW kernel "
        + json.dumps({_short(k): [c, round(ms, 4)]
                      for k, (c, ms) in sw_ev.items()}))
    out["sweep"] = aligner_sweep(dev, aligner, fqs[n], sam, sm_clock_mhz)
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


def query_times(dev, idx21) -> dict:
    length = cs.QUERY_LEN
    codes, _n_in = cs.query_codes(idx21.codes)
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


def sweep_times(dev, idx21) -> list[dict]:
    """The length sweep on both indexes; profiled at lengths 21 and 101."""
    from sapling_tpu_torch.ops import query

    rows = []
    for length in cs.SWEEP:
        codes, _n_in = cs.query_codes(idx21.codes, length)
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


def baseline_times(dev, idx21, tables) -> dict:
    codes, _n_in = cs.query_codes(idx21.codes)
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
    against = [a.split("=", 1)[1] for a in argv if a.startswith("--against=")]
    argv = [a for a in argv if not a.startswith("--against=")]
    out_path = argv[0] if argv else os.path.join(
        cs.ROOT, "chiprun_out", "measure.json")
    info = cs.card()
    log(f"card: {info['name_power']}, max SM clock {info['sm_clock_max']}, "
        f"{info['uuid']} on host {info['host']}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    sm_clock_mhz = float(info["sm_clock_max"].split()[0])

    seq, idx16, idx21, tables = cs.build_indexes(cs.GENOME_N)  # before CUDA
    sw_cuda.build_kernel()
    dev = torch.device("cuda", 0)
    res = dict(card=info, torch=torch.__version__, cuda=torch.version.cuda,
               sw=sw_times(dev, sm_clock_mhz,
                           against[0] if against else None))
    with tempfile.TemporaryDirectory(prefix="chip_measure_") as td:
        res["aligner"] = aligner_times(dev, seq, idx16, td, sm_clock_mhz)
    res["query"] = query_times(dev, idx21)
    res["sweep"] = sweep_times(dev, idx21)
    res["baselines"] = baseline_times(dev, idx21, tables)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    log(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
