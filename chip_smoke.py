#!/usr/bin/env python3
"""Chip smoke test: drive the PyTorch port's main path once on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA GPU (H100,
sm_90a). It needs no network and nothing but the checkout: the CUDA kernel
and the native host library are built from the repository's sources at
first use. Phases, each printing a line (the sweep one per length); any
failure raises and the script exits non-zero:

  1. the card (nvidia-smi name and power limit, its maximum SM clock,
     then its UUID and the host's name); no CUDA -> failure;
  2. build: a 4.6 Mbp benchmark genome (15% duplications and tandem
     repeats), ONE suffix array, a k=16 aligner index and a k=21 query
     index on the host (before CUDA starts: the host build may fork), then
     the SW kernels (nvcc, sm_90a);
  3. kernel vs plain: the CUDA SW kernels against the plain PyTorch
     sw_pass on the card, at the aligner's shapes (16384 pairs, 100-base
     reads padded to 112 rows, 128-base windows, ragged lengths, related
     lanes), pad 16 and pad 8 + second_inclusive, full and score-only,
     and terminate: every field must be equal; the score-only kernel
     also at one aligner block's candidate sweep (163,840 pairs), and both
     modes at 1,500-base reads (1,024 pairs, two row tiles of 1,024 rows);
     CUDA-event times of both, beside each one's bound (sw_bound_ms);
  4. aligner: 20,000 simulated 100 bp reads (1% substitutions) FASTQ ->
     SAM on the card; the first 1,000 reads' SAM must be byte-identical to
     the port's CPU path, and both SW kernel modes must have launched;
  4b. aligner without prefix arrays: the first 1,000 reads again, on a copy
     of the k=16 index without prefix64/prefix3, so every seed takes the
     general path over the packed genome; the SAM must be byte-identical to
     phase 4's;
  5. query: 1,000,000 21-base queries (7/8 from the genome, 1/8 random)
     on the k=21 index on the card; every in-genome query must self-check
     and the first 100,000 positions must equal the CPU path's;
  6. length sweep: the reference's lengths 11, 21, 31, 41, 51 and 101,
     1,000,000 queries each, on the k=21 index as built (fast3 up to 21,
     then prefix64 probes up to 32, then the packed genome) and on a copy
     without prefix64/prefix3 (packed-genome probes throughout); at
     lengths >= k every in-genome query must self-check (below k the
     reference's algorithm does not promise it), the two indexes must
     agree on every lane and the first 100,000 positions must equal the
     CPU path's;
     CUDA-event times, phase D bisection rounds and phase C stride steps;
  7. baselines: the plain and the llcp/rlcp-pruned binary search on phase
     5's queries; in-genome queries must self-check and the first 100,000
     positions must equal the CPU path's.

The line before the last is a JSON object describing each kernel; the last
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20260816
GENOME_N = 4_600_000
N_READS = 20_000
READ_LEN = 100
N_SAM_CHECK = 1_000
N_QUERIES = 1_000_000
QUERY_LEN = 21
N_QUERY_CHECK = 100_000
SWEEP = (11, 21, 31, 41, 51, 101)   # tools/sapling_example.py at k=21
SW_BATCH, SW_W, SW_R = 16_384, 100, 128
SW_SWEEP = 163_840                  # candidates of one 16,384-read block
SW_TILED, SW_TILED_W, SW_TILED_R = 1_024, 1_500, 1_600   # two row tiles
# the card's rates for the bound, an SM a clock (Hopper): int32 ALU lanes,
# and instructions issued (4 schedulers x 32 lanes, over the ALU and FMA
# pipes together); HBM bytes/s
INT32_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12
# int32 instructions a DP cell needs: the substitution as one byte-permute
# lookup, max(diag + sub, E, 0) and the max with F for H, H - gapO, an
# add-max each for E and F, half a 3-way max for the running max; all but
# the subtract (an IMAD on the FMA pipe) take the int32 ALU
SW_OPS_PER_CELL = 6.5
SW_ALU_OPS_PER_CELL = 5.5


def log(msg: str) -> None:
    print(msg, flush=True)


def build_indexes(genome_n: int):
    """Host phase: one suffix array, two index builds (k=16, k=21) on the
    CPU and the llcp/rlcp tables of the pruned binary search. Returns
    (seq, idx16, idx21, (llcp, rlcp))."""
    import numpy as np

    from sapling_tpu_torch.config import IndexConfig
    from sapling_tpu_torch.index.sapling import SaplingIndex
    from sapling_tpu_torch.index.suffix_array import (build_llcp_rlcp,
                                                      build_suffix_data)
    from sapling_tpu_torch.io.fasta import Genome
    from sapling_tpu_torch.sim.genomes import benchmark_genome

    seq = benchmark_genome(genome_n, seed=SEED)
    genome = Genome(seq=seq, chr_ends=[(genome_n, "bench")])
    suffix = build_suffix_data(seq, np.int32)
    # on the CPU: the phases below take each to the card with .to(dev)
    # and keep these as the CPU path they are held against
    idx16 = SaplingIndex.build(genome, IndexConfig(k=16), suffix=suffix,
                               device="cpu")
    idx21 = SaplingIndex.build(genome, IndexConfig(k=21, buckets=22),
                               suffix=suffix, keep_aligner_arrays=False,
                               device="cpu")
    tables = build_llcp_rlcp(np.asarray(suffix.lcp, np.int64), genome_n)
    return seq, idx16, idx21, tables


def without_prefix(idx):
    """A copy of `idx` without prefix64/prefix3 and with no device arrays
    yet (as an index above IndexConfig.prefix_max_n is built): every probe
    reads the packed genome."""
    return dataclasses.replace(idx, prefix64=None, prefix3=None, _device={})


def _time_ms(fn, dev, reps: int = 10, warm: int = 2) -> float:
    """CUDA-event milliseconds per call of fn (utils.timing.timed)."""
    from sapling_tpu_torch.utils.timing import timed

    return timed(fn, dev, reps=reps, warm=warm)[1] * 1e3


def card() -> dict:
    """The card as nvidia-smi reports it (name and power limit, its UUID)
    and the host's name, so that two calls' numbers can be told apart by
    the machine they ran on."""
    import socket

    def smi(fields):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()

    return dict(name_power=smi("name,power.limit"),
                sm_clock_max=smi("clocks.max.sm"), uuid=smi("uuid"),
                host=socket.gethostname())


def sw_bound_ms(qlen, rlen, w: int, r: int, out_words: int,
                sm_clock_mhz: float) -> dict:
    """The least time a SW pass over these pairs can take on this card:
    the larger of its instructions and its bytes. Instructions: for each
    real cell (qlen * rlen clipped to the shapes) SW_ALU_OPS_PER_CELL on
    the SMs' INT32_LANES_PER_SM, or SW_OPS_PER_CELL at their
    ISSUE_LANES_PER_SM, whichever takes longer, at the SM clock. Bytes:
    codes, lengths and terminate read once, out_words int32 a pair written
    once, over HBM_BYTES_PER_S. Returns {"bound_ms", "bound_by", "cells"}."""
    import torch

    b = int(qlen.shape[0])
    cells = int((qlen.long().clamp(0, w) * rlen.long().clamp(0, r)).sum())
    sms = torch.cuda.get_device_properties(qlen.device).multi_processor_count
    lane_clocks = max(SW_ALU_OPS_PER_CELL / INT32_LANES_PER_SM,
                      SW_OPS_PER_CELL / ISSUE_LANES_PER_SM)
    ops_ms = cells * lane_clocks / (sms * sm_clock_mhz * 1e6) * 1e3
    bytes_ms = b * (w + r + 12 + 4 * out_words) / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                cells=cells)


def sw_batch(dev, b: int, w: int = SW_W, r: int = SW_R):
    """A seeded batch of b SW pairs at aligner shapes (or reads of w bases
    in windows of r) on `dev`: (query, qlen, ref, rlen) with ragged lengths
    and every third lane related."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    q = rng.integers(0, 5, (b, w)).astype(np.int8)
    ref = rng.integers(0, 5, (b, r)).astype(np.int8)
    for i in range(0, b, 3):            # related lanes score high
        off = int(rng.integers(0, r - w + 1))
        ref[i, off:off + w] = q[i]
    qlen = rng.integers(w - 30, w + 1, b).astype(np.int32)
    rlen = rng.integers(r - 40, r + 1, b).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (q, qlen, ref, rlen))


def kernel_vs_plain(dev, sm_clock_mhz: float) -> dict:
    """Phase 3: the kernel wrapper against the plain sw_pass on `dev`, and
    each mode's time beside its bound; the score-only kernel also at
    SW_SWEEP pairs, and both modes at SW_TILED_W-base reads."""
    import torch

    from sapling_tpu_torch.ops.sw import sw_pass
    from sapling_tpu_torch.ops.sw_cuda import sw_pass_cuda

    q, qlen, ref, rlen = sw_batch(dev, SW_BATCH)
    no_term = torch.full((SW_BATCH,), -1, dtype=torch.int32, device=dev)
    term = sw_pass(q, qlen, ref, rlen, no_term)["score"].contiguous()
    cases = [("pad16", no_term, dict(pad_to=16)),
             ("pad8", no_term, dict(pad_to=8, second_inclusive=True)),
             ("terminate", term, dict(pad_to=16))]
    err = {"full": 0, "score_only": 0}

    def check(name, q, qlen, ref, rlen, tm, cases):
        for case, tm_, kw in cases:
            for so in (False, True):
                if so and tm_ is not tm:
                    continue           # score-only takes no terminate
                a = sw_pass(q, qlen, ref, rlen, tm_, score_only=so, **kw)
                k = sw_pass_cuda(q, qlen, ref, rlen, tm_, score_only=so,
                                 **kw)
                mode = "score_only" if so else "full"
                for f in a:
                    d = int((a[f].long() - k[f].long()).abs().max())
                    err[mode] = max(err[mode], d)
                    if d:
                        raise AssertionError(
                            f"kernel != plain: {name} {case} {mode} field "
                            f"{f}: {int((a[f] != k[f]).sum())} lanes differ")

    check(f"B={SW_BATCH}", q, qlen, ref, rlen, no_term, cases)
    out = {m: {"max_abs_err": err[m]} for m in err}
    for mode, so in (("full", False), ("score_only", True)):
        out[mode]["ms"] = _time_ms(lambda: sw_pass_cuda(
            q, qlen, ref, rlen, no_term, score_only=so), dev)
        out[mode]["plain_ms"] = _time_ms(lambda: sw_pass(
            q, qlen, ref, rlen, no_term, score_only=so), dev,
            reps=3, warm=1)
        bound = sw_bound_ms(qlen, rlen, SW_W, SW_R, 1 if so else 5,
                            sm_clock_mhz)
        out[mode].update(bound_ms=bound["bound_ms"],
                         bound_by=bound["bound_by"], library_ms=None,
                         pct_of_bound=100 * bound["bound_ms"]
                         / out[mode]["ms"])
    del q, qlen, ref, rlen, no_term, term

    # the score-only sweep at one aligner block's candidates
    q, qlen, ref, rlen = sw_batch(dev, SW_SWEEP)
    no_term = torch.full((SW_SWEEP,), -1, dtype=torch.int32, device=dev)
    a = sw_pass(q, qlen, ref, rlen, no_term, score_only=True)["score"]
    k = sw_pass_cuda(q, qlen, ref, rlen, no_term, score_only=True)["score"]
    d = int((a.long() - k.long()).abs().max())
    if d:
        raise AssertionError(f"kernel != plain: score-only at B={SW_SWEEP}:"
                             f" {int((a != k).sum())} lanes differ")
    ms = _time_ms(lambda: sw_pass_cuda(q, qlen, ref, rlen, no_term,
                                       score_only=True), dev)
    bound = sw_bound_ms(qlen, rlen, SW_W, SW_R, 1, sm_clock_mhz)
    out["score_only"][f"b{SW_SWEEP}"] = dict(
        max_abs_err=d, ms=ms, bound_ms=bound["bound_ms"],
        pct_of_bound=100 * bound["bound_ms"] / ms)
    del q, qlen, ref, rlen, no_term

    # reads past one row tile: both modes, pad 16, pad 8 and terminate
    w, r = SW_TILED_W, SW_TILED_R
    q, qlen, ref, rlen = sw_batch(dev, SW_TILED, w, r)
    no_term = torch.full((SW_TILED,), -1, dtype=torch.int32, device=dev)
    term = sw_pass(q, qlen, ref, rlen, no_term)["score"].contiguous()
    check(f"W={w}", q, qlen, ref, rlen, no_term,
          [("pad16", no_term, dict(pad_to=16)),
           ("pad8", no_term, dict(pad_to=8, second_inclusive=True)),
           ("terminate", term, dict(pad_to=16))])
    for mode, so in (("full", False), ("score_only", True)):
        ms = _time_ms(lambda: sw_pass_cuda(q, qlen, ref, rlen, no_term,
                                           score_only=so), dev)
        bound = sw_bound_ms(qlen, rlen, w, r, 1 if so else 5, sm_clock_mhz)
        out[mode][f"w{w}"] = dict(ms=ms, bound_ms=bound["bound_ms"],
                                  pct_of_bound=100 * bound["bound_ms"] / ms)
    out["full"]["max_abs_err"] = err["full"]
    out["score_only"]["max_abs_err"] = err["score_only"]
    return out


def aligner_phase(dev, seq, idx16, workdir: str) -> dict:
    """Phase 4: FASTQ -> SAM on `dev`; the first N_SAM_CHECK reads
    byte-checked against the CPU path. Returns counts, rates and launch
    counts."""
    n_reads, n_check = N_READS, N_SAM_CHECK
    from sapling_tpu_torch.align.aligner import SeedExtendAligner
    from sapling_tpu_torch.config import AlignerConfig
    from sapling_tpu_torch.io.fastq import read_fastq
    from sapling_tpu_torch.ops import sw_cuda
    from sapling_tpu_torch.sim.genomes import simulate_reads, write_fastq

    reads, true_pos, _rc = simulate_reads(seq, n_reads, READ_LEN,
                                          sub_rate=0.01, seed=SEED + 1)
    fq = os.path.join(workdir, "reads.fq")
    fq_head = os.path.join(workdir, "reads_head.fq")
    write_fastq(fq, reads)
    write_fastq(fq_head, reads[:n_check])
    aligner = SeedExtendAligner(idx16, AlignerConfig(), device=dev)
    # one warm block: first-use setup (device arrays, kernel load)
    aligner.align_block(list(read_fastq(fq_head)))

    sam = os.path.join(workdir, "dev.sam")
    for k in sw_cuda.LAUNCHES:
        sw_cuda.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    aligner.align_fastq(fq, sam, cl="chip_smoke")
    dt = time.perf_counter() - t0
    launches = dict(sw_cuda.LAUNCHES)

    cpu_sam = os.path.join(workdir, "cpu.sam")
    SeedExtendAligner(idx16, AlignerConfig(), device="cpu").align_fastq(
        fq_head, cpu_sam, cl="chip_smoke")
    with open(sam, "rb") as f:
        dev_lines = f.read().split(b"\n")
    with open(cpu_sam, "rb") as f:
        cpu_lines = f.read().split(b"\n")
    n_head = sum(1 for ln in dev_lines if ln.startswith(b"@"))
    want = cpu_lines[:n_head + n_check]
    if dev_lines[:n_head + n_check] != want:
        bad = next(i for i, (a, b) in enumerate(zip(dev_lines, want))
                   if a != b)
        raise AssertionError(f"SAM differs from the CPU path at line {bad}")

    # 4b: the same head without prefix arrays (the general seed path)
    bare = SeedExtendAligner(without_prefix(idx16), AlignerConfig(),
                             device=dev)
    bare_sam = os.path.join(workdir, "bare.sam")
    t0 = time.perf_counter()
    bare.align_fastq(fq_head, bare_sam, cl="chip_smoke")
    bare_s = time.perf_counter() - t0
    with open(bare_sam, "rb") as f:
        bare_lines = f.read().split(b"\n")
    if bare_lines[:n_head + n_check] != dev_lines[:n_head + n_check]:
        bad = next(i for i, (a, b) in enumerate(zip(bare_lines, dev_lines))
                   if a != b)
        raise AssertionError("SAM without prefix arrays differs from "
                             f"phase 4's at line {bad}")

    aligned = near = 0
    recs = [ln.split(b"\t") for ln in dev_lines[n_head:] if ln]
    if len(recs) != n_reads:
        raise AssertionError(f"{len(recs)} SAM records for {n_reads} reads")
    for i, rec in enumerate(recs):
        if int(rec[1]) != 4:
            aligned += 1
            near += abs(int(rec[3]) - 1 - int(true_pos[i])) <= 10
    return dict(reads_per_s=n_reads / dt, seconds=dt, aligned=aligned,
                near=near, launches=launches, sam_checked=n_check,
                phases=dict(aligner.phase_seconds), bare_seconds=bare_s)


def query_codes(seq, length: int = QUERY_LEN):
    """Seeded query codes [N_QUERIES, length]: the first n_in taken from
    the genome, the last N_QUERIES // 8 random. Returns (codes, n_in)."""
    import numpy as np

    from sapling_tpu_torch.ops import pack as packops

    n_q = N_QUERIES
    rng = np.random.default_rng(SEED + 2)
    n_in = n_q - n_q // 8
    starts = rng.integers(0, len(seq) - length + 1, n_in)
    q = np.concatenate([
        seq[starts[:, None] + np.arange(length)],
        np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, (n_q - n_in, length))]])
    return packops.encode_bases(q), n_in


def query_phase(dev, seq, idx21) -> dict:
    """Phase 5: 21-base plquery on `dev`, self-checked, positions held
    against the CPU path on the first N_QUERY_CHECK queries."""
    import numpy as np

    length, n_check = QUERY_LEN, N_QUERY_CHECK
    codes, n_in = query_codes(seq)
    didx = idx21.to(dev)
    inputs = didx.query_inputs(codes)
    pos = didx.query_device(*inputs, length).cpu().numpy()
    ok = didx.verify_hits(codes, pos)
    if not ok[:n_in].all():
        raise AssertionError(
            f"{int((~ok[:n_in]).sum())} in-genome queries failed self-check")
    want = idx21.to("cpu").query_positions(codes[:n_check])
    if not np.array_equal(pos[:n_check], want):
        raise AssertionError(
            f"{int((pos[:n_check] != want).sum())} positions differ from "
            "the CPU path")
    out = dict(self_check=int(ok[:n_in].sum()), in_genome=n_in,
               random_found=int(ok[n_in:].sum()))
    ms = _time_ms(lambda: didx.query_device(*inputs, length), dev,
                  reps=5, warm=1)
    out.update(ms=ms, qps=N_QUERIES / (ms / 1e3))
    return out


def _check(name, pos, ok, n_in, want, every: bool = True):
    """Fail unless the first len(want) positions equal the CPU path's and,
    with `every`, every in-genome query self-checked."""
    import numpy as np

    if every and not ok[:n_in].all():
        raise AssertionError(f"{name}: {int((~ok[:n_in]).sum())} in-genome "
                             "queries failed self-check")
    if not np.array_equal(pos[:len(want)], want):
        raise AssertionError(f"{name}: {int((pos[:len(want)] != want).sum())}"
                             " positions differ from the CPU path")


def _probe_form(idx, length: int) -> str:
    if idx.prefix3 is not None and length <= min(idx.k, 21):
        return "fast3"
    if idx.prefix64 is not None and length <= 32:
        return "prefix64"
    return "packed"


def sweep_phase(dev, seq, idx21) -> list[dict]:
    """Phase 6: the length sweep on the k=21 index as built and without
    its prefix arrays; per length and index: probe form, CUDA-event ms,
    q/s, and the host loop rounds of one call (ops.query.ROUNDS)."""
    import numpy as np

    from sapling_tpu_torch.ops import query

    indexes = (("built", idx21), ("no_prefix", without_prefix(idx21)))
    rows = []
    for length in SWEEP:
        codes, n_in = query_codes(seq, length)
        row = {"length": length}
        got = []
        for name, idx in indexes:
            didx = idx.to(dev)
            inputs = didx.query_inputs(codes)
            query.ROUNDS.update(C=0, D=0)
            pos = didx.query_device(*inputs, length).cpu().numpy()
            rounds = dict(query.ROUNDS)
            ms = _time_ms(lambda: didx.query_device(*inputs, length), dev,
                          reps=3, warm=1)
            row[name] = dict(form=_probe_form(idx, length), ms=ms,
                             qps=N_QUERIES / (ms / 1e3),
                             stride_steps=rounds["C"],
                             bisect_rounds=rounds["D"])
            got.append(pos)
        want = idx21.query_positions(codes[:N_QUERY_CHECK])
        ok = idx21.verify_hits(codes, got[0])
        # below k the reference's windows, measured for k-mers, need not
        # hold a short query's suffix range: it may answer an unverified
        # rank (sapling_tpu answers the same, tests/test_torch_query.py)
        _check(f"L={length}", got[0], ok, n_in, want,
               every=length >= idx21.k)
        if not np.array_equal(got[0], got[1]):
            raise AssertionError(
                f"L={length}: {int((got[0] != got[1]).sum())} lanes differ "
                "between the index with and without prefix arrays")
        row["self_check"] = int(ok[:n_in].sum())
        row["in_genome"] = n_in
        rows.append(row)
    return rows


def baseline_runs(didx, codes, tables) -> dict:
    """{name: device call} of the two binary searches over `codes` on
    `didx` (an index on the card): the plain and the llcp/rlcp-pruned."""
    import torch

    length = int(codes.shape[1])
    qw = didx.query_words(codes)
    lr = [torch.from_numpy(a).to(didx.device) for a in tables]
    return {"binsearch": lambda: didx.binsearch_device(qw, length),
            "fancy": lambda: didx.binsearch_device(qw, length, *lr)}


def baseline_phase(dev, seq, idx21, tables) -> dict:
    """Phase 7: the plain and the llcp/rlcp-pruned binary search on phase
    5's queries, self-checked and held against the CPU path."""
    codes, n_in = query_codes(seq)
    didx = idx21.to(dev)
    on_cpu = {"binsearch": lambda c: idx21.query_positions_binsearch(c),
              "fancy": lambda c: idx21.query_positions_fancy(c, *tables)}
    out = {}
    for name, run in baseline_runs(didx, codes, tables).items():
        pos = run().cpu().numpy()
        _check(name, pos, didx.verify_hits(codes, pos), n_in,
               on_cpu[name](codes[:N_QUERY_CHECK]))
        ms = _time_ms(run, dev, reps=3, warm=1)
        out[name] = dict(ms=ms, qps=N_QUERIES / (ms / 1e3))
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch  # noqa: F401  (fails here on a machine without PyTorch)

    from sapling_tpu_torch.ops import sw_cuda

    # 1. the card
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    info = card()
    log(info["name_power"])
    log(f"card: max SM clock {info['sm_clock_max']} (the bound's clock); "
        f"{info['uuid']} on host {info['host']}")
    sm_clock_mhz = float(info["sm_clock_max"].split()[0])

    # 2. build (host indexes first: nothing has touched CUDA yet)
    t0 = time.perf_counter()
    seq, idx16, idx21, tables = build_indexes(GENOME_N)
    log(f"build: {GENOME_N} bp genome, k=16 and k=21 indexes and the "
        "llcp/rlcp tables on the host "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sw_cuda.build_kernel()
    log(f"build: SW kernels (nvcc sm_90a) in "
        f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)

    # 3. kernel vs plain on the card
    kp = kernel_vs_plain(dev, sm_clock_mhz)
    sweep = kp["score_only"][f"b{SW_SWEEP}"]
    tiled = {m: kp[m].pop(f"w{SW_TILED_W}") for m in ("full", "score_only")}
    log("kernel vs plain: all fields equal (pad16, pad8+second_inclusive, "
        f"terminate; full and score-only) at B={SW_BATCH} W={SW_W} R={SW_R}"
        f" and at B={SW_TILED} W={SW_TILED_W} R={SW_TILED_R} (two row "
        f"tiles), score-only also at B={SW_SWEEP}; " + ", ".join(
            f"{m} {kp[m]['ms']:.4f} ms vs plain {kp[m]['plain_ms']:.3f} ms, "
            f"bound {kp[m]['bound_ms']:.4f} ms ({kp[m]['pct_of_bound']:.1f}%"
            " of it)" for m in ("full", "score_only"))
        + f"; score-only at B={SW_SWEEP} {sweep['ms']:.4f} ms, bound "
        f"{sweep['bound_ms']:.4f} ms ({sweep['pct_of_bound']:.1f}%); at "
        f"W={SW_TILED_W} " + ", ".join(
            f"{m} {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['pct_of_bound']:.1f}%)" for m, t in tiled.items()))

    # 4. aligner (and 4b), 5. query, 6. length sweep, 7. baselines
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        al = aligner_phase(dev, seq, idx16, workdir=td)
    if min(al["launches"].values()) == 0:
        raise AssertionError(f"SW kernel not launched: {al['launches']}")
    log(f"aligner: {N_READS} reads in {al['seconds']:.3f} s = "
        f"{al['reads_per_s']:.1f} reads/s; aligned {al['aligned']}, within "
        f"10 bp of truth {al['near']}; first {al['sam_checked']} reads' SAM "
        f"byte-identical to the CPU path; launches {al['launches']}; "
        f"phases {json.dumps({k: round(v, 3) for k, v in al['phases'].items()})}")
    if al["aligned"] < 0.9 * N_READS or al["near"] < 0.8 * al["aligned"]:
        raise AssertionError(f"too few good alignments: {al}")
    log(f"aligner without prefix arrays: first {N_SAM_CHECK} reads in "
        f"{al['bare_seconds']:.3f} s; SAM byte-identical to phase 4's")
    qr = query_phase(dev, seq, idx21)
    log(f"query: {N_QUERIES} 21-base queries in {qr['ms']:.3f} ms = "
        f"{qr['qps']:.1f} q/s; self-check {qr['self_check']}/"
        f"{qr['in_genome']} in-genome; first {N_QUERY_CHECK} positions "
        "identical to the CPU path")
    for row in sweep_phase(dev, seq, idx21):
        log(f"sweep L={row['length']}: " + "; ".join(
            f"{name} ({r['form']}) {r['ms']:.3f} ms = {r['qps']:.1f} q/s, "
            f"{r['bisect_rounds']} bisection rounds, {r['stride_steps']} "
            "stride steps" for name, r in row.items()
            if isinstance(r, dict))
            + f"; self-check {row['self_check']}/{row['in_genome']} "
            "in-genome, both indexes agree on every lane, first "
            f"{N_QUERY_CHECK} identical to the CPU path")
    bl = baseline_phase(dev, seq, idx21, tables)
    log(f"baselines: {N_QUERIES} 21-base queries: binary search "
        f"{bl['binsearch']['ms']:.3f} ms = {bl['binsearch']['qps']:.1f} q/s, "
        f"llcp/rlcp-pruned {bl['fancy']['ms']:.3f} ms = "
        f"{bl['fancy']['qps']:.1f} q/s, plquery (phase 5) "
        f"{qr['qps']:.1f} q/s; in-genome self-checked, first "
        f"{N_QUERY_CHECK} identical to the CPU path")

    src = os.path.relpath(sw_cuda.SOURCE, ROOT)
    kernels = [
        {"name": "sw_pass_full", "route": "cuda", "source": src,
         "replaces": "sapling_tpu/ops/sw_pallas.py:36",
         "launches": al["launches"]["full"], **kp["full"]},
        {"name": "sw_pass_score_only", "route": "cuda", "source": src,
         "replaces": "sapling_tpu/ops/sw_pallas.py:81",
         "launches": al["launches"]["score_only"], **kp["score_only"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
