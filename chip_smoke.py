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
     the kernels, csrc/sw.cu, csrc/query.cu and csrc/nn_predict.cu (one
     nvcc each, sm_90a, at once); beside them, in a child process started
     first, phase 8's artifact: the port's build_big_index at SCALE_N
     bases (k=21, 2^SCALE_NB buckets, bounds, no prefix arrays, no stage
     cache) into a temporary directory, then its retable_index to
     2^SCALE_RETABLE_NB buckets (table only); it ends before phase 3;
  3. kernel vs plain: the CUDA SW kernels against the plain PyTorch
     sw_pass on the card, at the aligner's shapes (16384 pairs, 100-base
     reads padded to 112 rows, 128-base windows, ragged lengths, related
     lanes), pad 16 and pad 8 + second_inclusive, full and score-only,
     and terminate: every field must be equal; the score-only kernel
     also at one aligner block's candidate sweep (163,840 pairs), both
     modes at 1,500-base reads (1,024 pairs, two row tiles of 1,024 rows),
     and the full mode past the int32 key (SW_KEY64: a best score past
     2^21, the int64-key instantiation); CUDA-event times of both, beside
     each one's bound (sw_bound_ms);
  3b. query kernels vs plain: on the same CUDA tensors, 1,000,000 lanes a
     case, plquery_cuda must equal the plain plquery_batch on every lane,
     and the kernel's stats rounds the plain path's ROUNDS: every probe form
     at QK_LENGTHS on the k=21 index as built and without prefix arrays;
     an int64 copy of rev, adaptive bounds, a pred64 moved by up to
     QK_SHIFT ranks, and that with the stride cap QK_STRIDE_CAP, at
     QK_OPTION_LENGTHS; the NN engine's sampled form (rank records and a
     sample of their keys, NN-width windows, a pred64 moved by up to
     QK_NN_SHIFT ranks) at QK_OPTION_LENGTHS (past 32 bases the launch
     takes the records form) at each QK_SAMPLE_SHIFTS, and on phase 8's
     artifact at its own W; phase 8's artifact at SCALE_LENGTHS; and
     binsearch_cuda against binsearch_batch on phase 5's queries and on
     phase 8's artifact; the record builders, fancy_nodes_cuda (the
     pruned search's node records) and plquery_records_cuda (plquery's
     rank records), against the plain fancy_nodes / plquery_records,
     every word, with their times, bounds and bytes, on the k=21 index
     and on phase 8's artifact (its node records of its own llcp / rlcp
     tables, scale_tables, gathered and copied from its rank records);
     and fancy_binsearch_cuda, on records built
     once for each index outside the timed calls, against
     fancy_binsearch_batch on phase 5's queries with prefix64, without,
     with an int64 rev, at L=101 (packed) and shuffled (its trace the
     node records and genome windows it reads);
     fast3 at L=21, packed at L=101 and
     the binary searches also in a shuffled order (hits and misses
     mixed). Each case prints the kernel's CUDA-event time, the plain
     path's, the kernel's launches, its bound (query_bound_ms: the
     distinct 32-byte sectors its lanes read, from its sector trace, and
     the coalesced inputs and output, over HBM_BYTES_PER_S), its bound at
     the random-sector rate this run measures (random_sector_rate,
     query_rate_bound_ms) and the lane utilisation of its probe counts
     (lane_utilisation). Then
     nn_predict_cuda against the plain nn_predict on the card, every rank
     equal, for a seeded untrained model at phase 9's width (NN_CHUNKS x
     NN_UNITS, the k=21 index's dataset scaling), on phase 5's 1M x and on
     every genome k-mer, on phase 5's x sorted and on 1M x in one chunk;
     its time, the plain version's and its bound (nn_bound_ms), and the
     modelled shared-memory wavefronts of its parameter loads in the
     caller's lane order and in the kernel's grouped order
     (nn_shared_wavefronts);
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
     CUDA-event times, phase D bisection rounds and phase C stride steps
     (the kernel's stats);
  7. baselines: the plain and the llcp/rlcp-pruned binary search (the
     binsearch and fancy kernels) on phase 5's queries; in-genome queries
     must self-check and the first 100,000 positions must equal the CPU
     path's; the pruned search's first call also builds its node records
     (the records kernel, counted as fancy_nodes), once: the timed calls
     launch the search alone.
  8. scale: phase 2's artifact loaded memory-mapped without inv and the
     aligner's run arrays (SaplingIndex.load(skip, mmap), codes copied
     into RAM), 1,000,000 queries of 21 and of 101 bases (7/8 from the
     genome) on the card with the artifact's own table and then, after
     SaplingIndex.swap_table, with the retabled one: every in-genome query
     must self-check, the first 100,000 positions must equal the CPU
     path's, and rev and packed must stay the same device tensors across
     the swap; CUDA-event times, the index's device bytes and the peak
     device memory (torch.cuda.max_memory_allocated);
  9. NN predictor: the residual model trained on the card at
     bench_nn_query's width (models.serve.train_serving on the k=21 index,
     64 chunks x 16 units, 300 epochs, seed 0) and audited; the predicted
     ranks of every genome k-mer must equal the same model's on the CPU,
     and every audit error must lie inside the max windows; NNQueryEngine
     on phase 5's queries: every in-genome query must self-check and the
     first 100,000 positions must equal the CPU path's with the same
     model; one nn_predict and one plquery launch a call; CUDA-event time
     and bisection rounds, timed in turns with the PWL engine on the same
     inputs, and predict_ranks alone (the kernel) in turns with the plain
     nn_predict on the card; then test_models.py's small corpus fitted
     on the card and on the CPU from one set of initial parameters: equal
     stop epochs, loss histories within NN_TRAIN_RTOL;
 10. sharded serving (parallel/, torch.distributed): ranks in child
     processes started with spawn, which load what the phases above saved
     to the temporary directory (the k=16 and k=21 artifacts, phase 5's and
     phase 8's positions, phase 4's SAM, phase 9's trained family). World
     1 over NCCL: ShardedQueryEngine and IndexShardedEngine on phase 5's
     queries and on phase 8's artifact at L = 21 and 101 must equal those
     phases' positions. Two ranks on the one card over gloo (named here:
     NCCL refuses two ranks on one device): IndexShardedEngine at idx=2 on
     phase 8's artifact (equal positions, every in-genome query
     self-checks), ShardedQueryEngine at dp=2 on phase 5's queries (equal
     positions), align_fastq_multihost on phase 4's reads (the merged SAM
     byte-identical to phase 4's), error_histogram of phase 5's prediction
     errors (equal to numpy's bincount), and one shard_for_mesh step of
     phase 9's family at dp=1, tp=2 (loss and parameters within
     MULTI_TRAIN_ATOL of a one-rank step). CUDA-event times of each
     engine's query_device on the rank's own lanes beside the
     single-device index's, the collectives a call, the aligner's
     reads/s. A rank that fails, or a group that does not form, fails the
     phase;
 11. the last modules: utils.profiling's profile_trace around one
     phase-5 query call (the Chrome trace must exist and hold CUDA kernel
     events) and bench_fn on it; evalx on the host: compare_sam of phase
     4's SAM against the simulation's truth (equal to phase 4's counts),
     kmer_spectrum of the genome's LCP at k = 16 and 21 (distinct 21-mers
     == np.unique's count), per_bin_errors' p95 on the k=21 index's audit
     (its per-bin statistics at 2^EVALX_BINS bins); and the
     microbench_gather twin's every mode at GATHER_N elements (past 2^31:
     int64 indexes), GATHER_LANES lanes, GATHER_ITERS deep, randref and
     sorted at GATHER_GB GB, then randref again at each of
     GATHER_SWEEP_LANES lanes.

Phases 4 to 9 each count the kernels' launches over their main call
(`counted`): each must launch its kernel (phase 7's pruned search the
fancy kernel and, on its first call, fancy_nodes; phase 9's engine
nn_predict and plquery), and no plain
cascade may run a host round there.

The line before the last is a JSON object describing each kernel; the last
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shlex
import signal
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
# phase 8: bench_sweep's middle size, 46 Mbp, at 2^24 buckets (k=21, no
# prefix arrays: packed-genome probes), its 2^23 retable, two lengths.
# Not bench.py's 230 Mbp row: there the build alone took 473 s on the
# chip host's 8 cores (NVIDIA H100 80GB HBM3 machine), past a third of
# this script's time limit; the scale tools run 230 Mbp (README).
SCALE_N = 46_000_000
SCALE_NB, SCALE_RETABLE_NB = 24, 23
SCALE_LENGTHS = (21, 101)
# phase 9: bench_nn_query's defaults (64 chunks of 16 hidden units, 300
# epochs) on the k=21 index; predictions in batches of NN_BATCH k-mers;
# the card's and the CPU's training loss histories agree to NN_TRAIN_RTOL
NN_CHUNKS, NN_UNITS, NN_EPOCHS = 64, 16, 300
NN_BATCH = 1 << 22
NN_TRAIN_RTOL = 1e-9
# phase 10: the sharded training step against a one-rank step; the
# deadline of each world of ranks (seconds)
MULTI_TRAIN_ATOL = 1e-12
MULTI_TIMEOUT = 300
# phase 11: the gather microbenchmark's operands (the rev halves and 2D
# layouts hold GATHER_N entries, 8.8 GB) and lanes
GATHER_N, GATHER_LANES = 2_200_000_000, 5_000_000
GATHER_ITERS, GATHER_GB = 4, 12.4
# phase 11: randref's lane counts past GATHER_LANES (more gathers in
# flight)
GATHER_SWEEP_LANES = (50_000_000, 200_000_000)
# phase 11: the bins of evalx.bins.per_bin_errors' per-bin statistics
EVALX_BINS = 16
# phase 3b: the query kernels against the plain cascade on the card, at
# phase 5's query count: these lengths on the k=21 index as built and
# without prefix arrays; the options at QK_OPTION_LENGTHS; pred64 moved by
# up to QK_SHIFT ranks; the stride cap QK_STRIDE_CAP
QK_LENGTHS = (11, 16, 21, 31, 41, 51, 101)
QK_OPTION_LENGTHS = (21, 41)
QK_SHIFT, QK_STRIDE_CAP = 300, 2
# phase 3b: plquery's sampled form (the NN engine's) under windows of a
# quarter of the genome on each side and a pred64 moved by up to
# QK_NN_SHIFT ranks, with samples of one key every 2^shift ranks
QK_SAMPLE_SHIFTS = (3, 6)   # W = 8 and 64
QK_NN_SHIFT = 100_000
# the sector numbers a lane records for the bound (a lane that touches more
# records the first QK_TRACE: the distinct count stays a lower bound)
QK_TRACE = 128
# phase 3b: the card's random 32-byte sector rate, as a torch gather of
# SECTOR_RATE_LANES random int64 elements of a SECTOR_RATE_ELEMS table (4
# GB, past the 50 MB L2) reaches it: the second bound of each query case
SECTOR_RATE_ELEMS, SECTOR_RATE_LANES = 1 << 29, 1 << 24
# phase 3: a full-mode SW batch whose H passes 2^21, past the int32 key
# (the int64-key instantiation): SW_KEY64 pairs of SW_KEY64_W bases in
# windows as long, match SW_KEY64_MATCH
SW_KEY64, SW_KEY64_W, SW_KEY64_MATCH = 6, 1_100, 3_000
# the card's rates for the bound, an SM a clock (Hopper): int32 ALU lanes,
# instructions issued (4 schedulers x 32 lanes, over the ALU and FMA pipes
# together) and fp64 lanes; HBM bytes/s
INT32_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128
FP64_LANES_PER_SM = 64
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


def counted(fn, want: str | None = "plquery"):
    """fn() with the query and NN kernels' launch counts (ops.query_cuda
    and ops.nn_predict_cuda LAUNCHES) and the plain cascade's host loop
    rounds (ops.query.ROUNDS) set to 0 just before it and read just after:
    (result, launches, rounds). With `want`, fail unless that kernel
    launched and no plain cascade looped (a plain plquery or binary search
    of a real batch runs host rounds; the kernels add to ROUNDS only when
    asked for stats)."""
    from sapling_tpu_torch.ops import nn_predict_cuda, query, query_cuda

    for counts in (query_cuda.LAUNCHES, nn_predict_cuda.LAUNCHES):
        for k in counts:
            counts[k] = 0
    query.ROUNDS.update(C=0, D=0)
    out = fn()
    launches = {**query_cuda.LAUNCHES, **nn_predict_cuda.LAUNCHES}
    rounds = dict(query.ROUNDS)
    if want and (launches[want] == 0 or any(rounds.values())):
        raise AssertionError(f"{want} kernel not on the path: launches "
                             f"{launches}, plain rounds {rounds}")
    return out, launches, rounds


def planned(fn):
    """counted(fn) for a call of SaplingIndex.query_device without stats,
    which must launch from the index's launch plan (ops.query_cuda.PLANS
    "served" one up), so that the checks hold the path that every timed
    call takes."""
    from sapling_tpu_torch.ops import query_cuda

    served = query_cuda.PLANS["served"]
    got = counted(fn)
    if query_cuda.PLANS["served"] != served + 1:
        raise AssertionError("query_device did not launch from its plan")
    return got


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
    del q, qlen, ref, rlen, no_term, term

    # the full mode past the int32 key: the int64-key instantiation
    w = SW_KEY64_W
    q, qlen, ref, rlen = sw_batch(dev, SW_KEY64, w, w)
    no_term = torch.full((SW_KEY64,), -1, dtype=torch.int32, device=dev)
    kw = dict(match=SW_KEY64_MATCH)
    best = int(sw_pass(q, qlen, ref, rlen, no_term, **kw)["score"].max())
    if best < 1 << 21:
        raise AssertionError(f"the int64-key batch scores {best} < 2^21")
    check(f"int64 key W=R={w}", q, qlen, ref, rlen, no_term,
          [(f"match={SW_KEY64_MATCH}", no_term, kw)])
    out["full"]["key64"] = dict(pairs=SW_KEY64, w=w, best=best)
    out["full"]["max_abs_err"] = err["full"]
    out["score_only"]["max_abs_err"] = err["score_only"]
    return out


def query_bound_ms(sectors: int, b: int, lane_bytes: int) -> float:
    """The least time of a query kernel call: the distinct 32-byte sectors
    of the index arrays its lanes read (counted from the kernel's sector
    trace: each read once), and lane_bytes a lane of coalesced inputs and
    output read or written once, over HBM_BYTES_PER_S."""
    return (32 * sectors + b * lane_bytes) / HBM_BYTES_PER_S * 1e3


def query_rate_bound_ms(sectors: int, b: int, lane_bytes: int,
                        sectors_per_s: float) -> float:
    """query_bound_ms with the distinct sectors read at `sectors_per_s`,
    the random 32-byte sector rate this run measured on the card
    (random_sector_rate), in place of HBM_BYTES_PER_S."""
    return (sectors / sectors_per_s + b * lane_bytes / HBM_BYTES_PER_S) * 1e3


def random_sector_rate(dev) -> dict:
    """The card's rate of random 32-byte sector reads as a torch gather
    reaches it: SECTOR_RATE_LANES random int64 elements (seeded) of a
    SECTOR_RATE_ELEMS table; their distinct sectors over the gather's
    CUDA-event time (its coalesced index read and output write included)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    table = torch.zeros(SECTOR_RATE_ELEMS, dtype=torch.int64, device=dev)
    idx = torch.randint(0, SECTOR_RATE_ELEMS, (SECTOR_RATE_LANES,),
                        device=dev, generator=g)
    distinct = int(torch.unique(idx >> 2).numel())
    ms = _time_ms(lambda: table[idx], dev)
    del table, idx
    return dict(sectors_per_s=distinct / (ms / 1e3), ms=ms,
                distinct=distinct, lanes=SECTOR_RATE_LANES)


def shuffled(codes):
    """codes in a seeded random order. query_codes puts every random
    (mostly absent) query in the last eighth of the batch; the aligner's
    seeds mix hits and misses through it."""
    import numpy as np

    return codes[np.random.default_rng(SEED + 3).permutation(len(codes))]


def lane_utilisation(probes) -> float:
    """The share of a warp's probe slots that do a lane's probe, from the
    lanes' probe counts (int32 [B], in the batch's order): one thread a
    lane, so a warp of 32 consecutive lanes runs as long as its deepest."""
    import numpy as np

    p = np.asarray(probes, np.int64)
    g = np.pad(p, (0, -len(p) % 32)).reshape(-1, 32)
    return float(p.sum() / (32 * g.max(1)).sum())


def _kernel_case(dev, name, kernel, plain, lane_bytes, b,
                 sectors_per_s) -> dict:
    """One kernel-vs-plain case on the card: kernel() (which passes its
    keywords, stats and trace, to the wrapper) and plain() on the
    same CUDA tensors must agree on every lane, and the kernel's stats
    rounds must equal the plain path's ROUNDS. Returns the kernel's and the
    plain path's CUDA-event times, the kernel's launches a call, its bound
    (query_bound_ms over the distinct sectors of its trace) and its bound
    at the measured sector rate (query_rate_bound_ms, sectors_per_s), the
    sectors its lanes touched in all, the probes the rank sample decided,
    the rounds, and the lane utilisation (lane_utilisation)."""
    import numpy as np
    import torch

    from sapling_tpu_torch.ops import query, query_cuda

    query.ROUNDS.update(C=0, D=0)
    want = plain()
    rounds = dict(query.ROUNDS)
    query.ROUNDS.update(C=0, D=0)
    launches = query_cuda.LAUNCHES.copy()
    got = kernel(stats=True, trace=QK_TRACE)
    launched = sum(query_cuda.LAUNCHES.values()) - sum(launches.values())
    st = dict(query_cuda.LAST_STATS)
    tr = st.pop("trace")
    distinct = int(torch.unique(tr[tr >= 0]).numel())
    over = int((st["sectors"] > QK_TRACE).sum())
    del tr
    if not np.array_equal(got.cpu().numpy(), want.cpu().numpy()):
        raise AssertionError(f"query kernel != plain: {name}: "
                             f"{int((got != want).sum())} of {b} lanes differ")
    if dict(query.ROUNDS) != rounds:
        raise AssertionError(f"query kernel rounds {dict(query.ROUNDS)} != "
                             f"the plain path's {rounds}: {name}")
    ms = _time_ms(kernel, dev, reps=10, warm=2)
    bound = query_bound_ms(distinct, b, lane_bytes)
    rate_bound = query_rate_bound_ms(distinct, b, lane_bytes, sectors_per_s)
    return dict(name=name, ms=ms, plain_ms=_time_ms(plain, dev, reps=3,
                                                     warm=1),
                launches=launched, bound_ms=bound, pct_of_bound=100 * bound
                / ms, rate_bound_ms=rate_bound,
                pct_of_rate_bound=100 * rate_bound / ms,
                sectors=int(st["sectors"].sum()), distinct=distinct,
                over=over, probes=int(st["probes"].sum()),
                decided=int(st["sample_decided"].sum()), rounds=rounds,
                util=lane_utilisation(st["probes"].cpu()),
                max_abs_err=0)


def scale_tables(big):
    """The llcp / rlcp tables of the scale artifact's genome, on the host:
    its LCP (Kasai, over the artifact's own suffix array rev), then
    build_llcp_rlcp (a sparse table of ~5 GB at 46 Mbp)."""
    import numpy as np

    from sapling_tpu_torch.index.suffix_array import build_llcp_rlcp
    from sapling_tpu_torch.native import lcp_kasai
    from sapling_tpu_torch.ops import pack as packops

    rev = np.asarray(big.rev)
    _inv, lcp = lcp_kasai(packops.decode_bases(big.codes),
                          rev.astype(np.int64) if rev.dtype == np.uint32
                          else rev)
    return build_llcp_rlcp(np.asarray(lcp, np.int64), big.n)


def fancy_nodes_bound_ms(didx) -> float:
    """The least time of the pruned search's node records on `didx` (on
    the card): rev, llcp and rlcp read once, the packed genome's words
    that the ranks' keys read (all of them, to two past the last base),
    and n records of 32 bytes written once, over HBM_BYTES_PER_S."""
    d = didx.device_arrays()
    n = didx.n
    words = min(d["packed"].shape[0], (n - 1) // 16 + 3)
    return ((d["rev"].element_size() + 8 + 32) * n + 8 * words) \
        / HBM_BYTES_PER_S * 1e3


def fancy_nodes_case(dev, didx, lr, rank_recs=None) -> dict:
    """Phase 3b: the pruned search's node records of `didx` (on the card)
    and the tables lr: fancy_nodes_cuda (with rank_recs, the index's rank
    records, their first halves copied from them) against the plain
    ops.query.fancy_nodes on the same CUDA tensors, every word equal;
    both timed, the bound (fancy_nodes_bound_ms) and the records' bytes."""
    import torch

    from sapling_tpu_torch.ops import query, query_cuda

    args = (didx.device_arrays()["packed"], didx.device_arrays()["rev"],
            *lr)

    def kernel():
        return query_cuda.fancy_nodes_cuda(*args, n=didx.n,
                                           rank_recs=rank_recs)

    def plain():
        return query.fancy_nodes(*args, n=didx.n)

    got, want = kernel(), plain()
    if not torch.equal(got, want):
        raise AssertionError(
            f"fancy_nodes kernel != plain: {int((got != want).any(1).sum())}"
            f" of {didx.n} records differ")
    nbytes = got.numel() * got.element_size()
    del got, want
    ms = _time_ms(kernel, dev)
    bound = fancy_nodes_bound_ms(didx)
    return dict(n=didx.n, bytes=nbytes, ms=ms,
                plain_ms=_time_ms(plain, dev, reps=3, warm=1),
                bound_ms=bound, pct_of_bound=100 * bound / ms,
                max_abs_err=0)


def query_records_bound_ms(didx) -> dict:
    """The least times of plquery's record tables on `didx` (on the card):
    the bucket records read xlist and ylist (2^buckets + 1 words each) and
    bounds (if any) once and write 32 bytes a bucket; the rank records read
    rev and the packed genome's words the keys read (all of them, to two
    past the last base) once and write 16 bytes a rank; over
    HBM_BYTES_PER_S."""
    d = didx.device_arrays()
    nb, n = 1 << didx.buckets, didx.n
    words = min(d["packed"].shape[0], (n - 1) // 16 + 3)
    bucket = 2 * 8 * (nb + 1) + (0 if d["bounds"] is None else 4 * nb) \
        + 32 * nb
    rank = (d["rev"].element_size() + 16) * n + 8 * words
    return {"bucket_records": bucket / HBM_BYTES_PER_S * 1e3,
            "plquery_records": rank / HBM_BYTES_PER_S * 1e3}


def query_records_case(dev, didx) -> dict:
    """Phase 3b: plquery's record tables of `didx` (on the card):
    bucket_records_cuda and plquery_records_cuda against the plain
    ops.query.bucket_records / plquery_records on the same CUDA tensors,
    every word equal; each timed, with its plain version's time, its bound
    (query_records_bound_ms) and its table's bytes."""
    import torch

    from sapling_tpu_torch.ops import query, query_cuda

    d = didx.device_arrays()
    tab = (d["xlist"], d["ylist"], d["bounds"])
    runs = {"bucket_records": (
        lambda: query_cuda.bucket_records_cuda(*tab, buckets=didx.buckets),
        lambda: query.bucket_records(*tab, buckets=didx.buckets)),
        "plquery_records": (
        lambda: query_cuda.plquery_records_cuda(d["packed"], d["rev"],
                                                n=didx.n),
        lambda: query.plquery_records(d["packed"], d["rev"], n=didx.n))}
    bounds = query_records_bound_ms(didx)
    out = {}
    for name, (kernel, plain) in runs.items():
        got, want = kernel(), plain()
        if not torch.equal(got, want):
            raise AssertionError(
                f"{name} kernel != plain: {int((got != want).any(1).sum())}"
                f" of {len(got)} records differ")
        rows, nbytes = got.shape[0], got.numel() * got.element_size()
        del got, want
        ms = _time_ms(kernel, dev)
        out[name] = dict(rows=rows, bytes=nbytes, ms=ms,
                         plain_ms=_time_ms(plain, dev, reps=3, warm=1),
                         bound_ms=bounds[name],
                         pct_of_bound=100 * bounds[name] / ms,
                         max_abs_err=0)
    return out


def plquery_case(dev, rate, tag, idx, length: int, codes=None,
                 **over) -> dict:
    """One plquery case of phase 3b on `idx` (on the card): plquery_cuda
    against plquery_batch on plquery_inputs' tensors (_kernel_case, its
    second bound at `rate`, random_sector_rate's), the rank sample
    deciding probes in the "sampled key" form and nowhere else. Returns
    the case's row."""
    from sapling_tpu_torch.ops import query, query_cuda

    args, kw, form, lane_bytes, recs = plquery_inputs(idx, length, codes,
                                                      **over)
    tag += " records" if over.pop("ranks", False) else ""
    tag += " fast3" if over.pop("fast3", False) else ""
    if over.get("sample") is not None:
        tag += f" sample W={1 << over['sample']}"
    row = _kernel_case(
        dev, f"{tag} L={length} {form}",
        lambda **st: query_cuda.plquery_cuda(*args, **recs, **st, **kw),
        lambda: query.plquery_batch(*args, **kw), lane_bytes,
        len(args[5]), rate["sectors_per_s"])
    if (row["decided"] > 0) != (form == "sampled key"):
        raise AssertionError(f"the rank sample decided {row['decided']} "
                             f"probes: {row['name']}")
    return dict(row, kernel="plquery", length=length, form=form)


def query_kernel_phase(dev, idx21, art: str,
                       tables) -> tuple[list[dict], dict, dict, dict]:
    """Phase 3b: the query kernels against the plain cascade on the card,
    each case on the same CUDA tensors (_kernel_case): plquery at
    QK_LENGTHS on the k=21 index as built and without prefix arrays (every
    probe form); an int64 copy of rev; adaptive bounds; a pred64 moved by
    up to QK_SHIFT ranks, also with the stride cap QK_STRIDE_CAP; the
    sampled form under NN-width windows (nn_windows) on rank records made
    for it at each QK_SAMPLE_SHIFTS and on phase 8's artifact at its own
    W (query_cuda.sample_shift), the sample deciding probes there and
    nowhere else; phase 8's artifact at SCALE_LENGTHS; the binary search
    on both indexes; the pruned search's node records (fancy_nodes_case) and the search (with
    `tables`, the host llcp / rlcp, on records built once for each index,
    outside the timed calls) at QUERY_LEN with and without prefix64 and
    with an int64 rev, and at the last SCALE_LENGTHS; the record builders
    again on phase 8's artifact (fancy_nodes_case with its own tables,
    scale_tables, gathered and copied from its rank records, and
    query_records_case). plquery at QUERY_LEN
    and the last SCALE_LENGTHS, each binary search and the pruned one with
    prefix64 also run in a shuffled order. plquery runs on each index's
    record tables (query_records), made before its first case; at 4.6 Mbp
    (no rank records: rev and the genome fit the L2) every case also runs
    on rank records made for it ("records"), and up to QUERY_LEN, shuffled,
    under a shifted pred64 and with adaptive bounds on the fast3 probe
    ("fast3": the NN engine's).
    Every case's second bound reads the sector rate random_sector_rate
    measures first. Returns the cases' rows, the node records'
    (fancy_nodes_case on the k=21 index), plquery's record tables'
    (query_records_case on the k=21 index), the sector rate and the
    artifact's builders' rows ({"fancy_nodes": ..., "fancy_nodes_copied":
    (from its rank records), **query_records_case}, with the host seconds
    of its tables, "tables_s")."""
    import numpy as np
    import torch

    from sapling_tpu_torch.ops import query, query_cuda
    from sapling_tpu_torch.tools.bench_query_scale import load_for_queries

    rows = []
    rate = random_sector_rate(dev)

    def plquery_cases(tag, idx, length, codes=None, **over):
        rows.append(plquery_case(dev, rate, tag, idx, length, codes,
                                 **over))

    def binsearch_case(tag, didx, codes):
        qw, kw, lane_bytes = binsearch_inputs(didx, codes)
        d = didx.device_arrays()
        row = _kernel_case(
            dev, f"{tag}binary search L={QUERY_LEN}",
            lambda **st: query_cuda.binsearch_cuda(d["packed"], d["rev"],
                                                   qw, **st, **kw),
            lambda: query.binsearch_batch(d["packed"], d["rev"], qw, **kw),
            lane_bytes, len(codes), rate["sectors_per_s"])
        rows.append(dict(row, kernel="binsearch", length=QUERY_LEN,
                         form="packed"))

    def fancy_case(tag, didx, codes):
        qw, kw, lane_bytes = binsearch_inputs(didx, codes)
        d = didx.device_arrays()
        args = (d["packed"], d["rev"], *lr, qw)
        kw["prefix"] = d["prefix64"]
        nodes = query_cuda.fancy_nodes_cuda(*args[:4], n=didx.n)
        form = ("prefix64" if d["prefix64"] is not None
                and kw["length"] <= 32 else "packed")
        row = _kernel_case(
            dev, f"{tag}pruned binary search L={kw['length']} {form}",
            lambda **st: query_cuda.fancy_binsearch_cuda(
                *args, nodes=nodes, **st, **kw),
            lambda: query.fancy_binsearch_batch(*args, **kw), lane_bytes,
            len(codes), rate["sectors_per_s"])
        rows.append(dict(row, kernel="fancy", length=kw["length"],
                         form=form))

    bare = without_prefix(idx21)
    rec_row = query_records_case(dev, idx21.to(dev))
    built = idx21.to(dev)
    for length in QK_LENGTHS:
        codes, _n_in = query_codes(idx21.codes, length)
        for tag, idx, ranks in (("built", built, False),
                                ("built", built, True),
                                ("no_prefix", bare.to(dev), False)):
            plquery_cases(tag, idx, length, codes, ranks=ranks)
        if length <= QUERY_LEN:
            plquery_cases("built", built, length, codes, fast3=True)
    # shuffled: the measured cases with hits and misses mixed
    for length in (QUERY_LEN, SCALE_LENGTHS[-1]):
        codes, _n_in = query_codes(idx21.codes, length)
        for ranks in (False, True):
            plquery_cases("built shuffled", built, length, shuffled(codes),
                          ranks=ranks)
    plquery_cases("built shuffled", built, QUERY_LEN,
                  shuffled(query_codes(idx21.codes)[0]), fast3=True)
    rev64 = dataclasses.replace(idx21, rev=idx21.rev.astype(np.int64),
                                _device={}).to(dev)
    cap = QK_STRIDE_CAP
    for length in QK_OPTION_LENGTHS:
        for ranks in (False, True):
            plquery_cases("int64 rev", rev64, length, ranks=ranks)
            plquery_cases("adaptive", built, length, adaptive_bounds=True,
                          ranks=ranks)
            plquery_cases(f"pred64 +-{QK_SHIFT}", built, length,
                          shift=QK_SHIFT, ranks=ranks)
            plquery_cases(f"pred64 +-{QK_SHIFT} stride cap {cap}", built,
                          length, shift=QK_SHIFT, max_stride_steps=cap,
                          ranks=ranks)
    # the NN engine's probe: fast3 under a caller's prediction
    plquery_cases(f"pred64 +-{QK_SHIFT}", built, QUERY_LEN, shift=QK_SHIFT,
                  fast3=True)
    plquery_cases("adaptive", built, QUERY_LEN, adaptive_bounds=True,
                  fast3=True)
    # the NN engine's sampled form: the sample decides the wide bisection's
    # probes up to 32 bases; past them the records form reads every record
    for length in QK_OPTION_LENGTHS:
        for w_shift in QK_SAMPLE_SHIFTS:
            plquery_cases(f"pred64 +-{QK_NN_SHIFT} NN windows", built,
                          length, shift=QK_NN_SHIFT, ranks=True,
                          sample=w_shift, **nn_windows(built))
    codes, _n_in = query_codes(idx21.codes)
    binsearch_case("", idx21.to(dev), codes)
    binsearch_case("shuffled ", idx21.to(dev), shuffled(codes))
    lr = [torch.from_numpy(a).to(dev) for a in tables]
    node_row = fancy_nodes_case(dev, idx21.to(dev), lr)
    fancy_case("", idx21.to(dev), codes)
    fancy_case("no_prefix ", bare.to(dev), codes)
    fancy_case("shuffled ", idx21.to(dev), shuffled(codes))
    fancy_case("int64 rev ", rev64, codes)
    del rev64
    codes, _n_in = query_codes(idx21.codes, SCALE_LENGTHS[-1])
    fancy_case("", idx21.to(dev), codes)
    del lr
    big = load_for_queries(art, dev)
    for length in SCALE_LENGTHS:
        codes, _n_in = query_codes(big.codes, length)
        plquery_cases(f"{big.n} bp", big, length, codes)
        plquery_cases(f"{big.n} bp shuffled", big, length, shuffled(codes))
    codes, _n_in = query_codes(big.codes)
    plquery_cases(f"{big.n} bp pred64 +-{QK_NN_SHIFT} NN windows", big,
                  QUERY_LEN, codes, shift=QK_NN_SHIFT, ranks=True,
                  sample=query_cuda.sample_shift(
                      big.n, query_cuda.l2_bytes(dev)), **nn_windows(big))
    binsearch_case(f"{big.n} bp ", big, codes)
    binsearch_case(f"{big.n} bp shuffled ", big, shuffled(codes))
    t0 = time.perf_counter()
    lr = [torch.from_numpy(a).to(dev) for a in scale_tables(big)]
    scale_rows = dict(tables_s=time.perf_counter() - t0,
                      fancy_nodes=fancy_nodes_case(dev, big, lr),
                      fancy_nodes_copied=fancy_nodes_case(
                          dev, big, lr, big.query_records()[1]),
                      **query_records_case(dev, big))
    del big, lr
    return rows, node_row, rec_row, rate, scale_rows


def nn_bound_ms(b: int, c: int, s: int, sm_clock_mhz: float,
                sms: int) -> dict:
    """The least time of an nn_predict call over b lanes with c chunks of s
    units on this card: the larger of its fp64 operations and its bytes.
    Operations a lane, as nn_predict.cu issues them on the fp64 pipe: the
    int64 -> fp64 conversion, the division, the rounding to float32 and
    back, for each unit a multiply, an add and a ReLU, a multiply and
    (but the first) an add for the sum, the b2 add, two multiplies, two
    adds and a subtract for the un-scaling, the rounding, two clamp
    compares and the conversion to int64: 5 s + 13, on FP64_LANES_PER_SM
    lanes an SM a clock at the SM clock. Bytes: x read and the rank
    written once (16 a lane) and the parameters once, over
    HBM_BYTES_PER_S."""
    ops = b * (5 * s + 13)
    ops_ms = ops / (sms * FP64_LANES_PER_SM * sm_clock_mhz * 1e6) * 1e3
    nbytes = 16 * b + 4 * c + 8 * c * (3 * s + 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                bytes_ms=bytes_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def nn_shared_wavefronts(chunks, units: int, tile: int) -> dict:
    """A model of the shared-memory wavefronts of nn_predict's parameter
    loads: w1, b1 and w2 of each unit and b2, 3 s + 1 loads of 8 bytes a
    lane from the [s][C] staging, where every load of a lane's chunk c sits
    in bank pair (c + a constant) mod 16. `chunks` are the lanes' chunks in
    the caller's order. Warps: 32 consecutive lanes of that order (a
    grid-stride kernel, one thread a lane), or of each tile of `tile`
    lanes sorted by chunk (the grouped kernel). Two rules for an 8-byte load: the whole warp at
    once (a wavefront for each distinct address in the fullest bank pair),
    or each half-warp apart (the sum of its two halves'). Returns, per
    order and rule, the mean wavefronts of a load and of a warp's 3 s + 1
    loads, and the count of warps."""
    import numpy as np

    chunks = np.asarray(chunks, np.int64)
    n, c_max = len(chunks), int(chunks.max()) + 1
    tiles = np.arange(n) // tile
    orders = {"caller": chunks,
              "grouped": chunks[np.lexsort((chunks, tiles))]}
    out = dict(warps=-(-n // 32), loads_a_lane=3 * units + 1)
    for name, order in orders.items():
        for rule, group in (("warp", 32), ("half", 16)):
            g = np.arange(n) // group
            key = np.unique(g * c_max + order)     # distinct (group, chunk)
            gg, cc = key // c_max, key % c_max
            fullest = np.bincount(gg * 16 + cc % 16,
                                  minlength=(g[-1] + 1) * 16)
            fullest = fullest.reshape(-1, 16).max(1)
            per_warp = np.bincount(np.arange(len(fullest)) * group // 32,
                                   weights=fullest)
            out[f"{name}_{rule}"] = dict(
                per_load=float(per_warp.mean()),
                per_warp=float(per_warp.mean()) * (3 * units + 1))
    return out


def nn_model_args(srv):
    """A NNServing's nn_predict arguments: (args, keywords)."""
    return ((srv.xb, srv.params[0]["w"], srv.params[0]["b"],
             srv.params[1]["w"], srv.params[1]["b"]),
            dict(x_max=srv.x_max, line_m=srv.line_m, line_c=srv.line_c,
                 res_ptp=srv.res_ptp, res_min=srv.res_min, n=srv.n))


def nn_untrained(dev, idx21):
    """A seeded untrained model at phase 9's width on `dev`: init_params
    (NN_CHUNKS x NN_UNITS, seed SEED) with the chunk boundaries and
    scaling of the k=21 index's dataset. Returns (NNServing, the genome's
    k-mers on the host)."""
    import numpy as np
    import torch

    from sapling_tpu_torch.models.residual import (init_params,
                                                   prepare_dataset)
    from sapling_tpu_torch.models.serve import NNServing
    from sapling_tpu_torch.ops.pack import kmers_scan

    kmers = kmers_scan(idx21.codes, idx21.k)
    ds = prepare_dataset(kmers, np.asarray(idx21.inv[:len(kmers)],
                                           np.int64), NN_CHUNKS)
    srv = NNServing(
        params=init_params(torch.Generator().manual_seed(SEED),
                           ds.x.shape[0], NN_UNITS, device=dev),
        xb=torch.from_numpy(np.ascontiguousarray(
            ds.x[:, 0, 0], dtype=np.float32)).to(dev),
        x_max=ds.x_max, res_min=ds.res_min, res_ptp=ds.res_ptp,
        line_m=ds.line_m, line_c=ds.line_c, n=idx21.n, k=idx21.k)
    return srv, kmers


def nn_batches(x, srv) -> dict:
    """Phase 3b's other NN batches beside phase 5's x: x sorted (a warp's
    lanes share a chunk in the caller's order), and as many lanes drawn
    (seed SEED) from the middle half of the widest chunk of srv's
    boundaries (x / x_max rounds to float32, whose step at k = 21 spans
    some 2^18 k-mers, so that the edges of a chunk are not its own)."""
    import numpy as np
    import torch

    from sapling_tpu_torch.ops.nn_predict_cuda import nn_route

    edges = np.round(srv.xb.cpu().numpy().astype(np.float64) * srv.x_max)
    edges = np.append(edges, srv.x_max).astype(np.int64)
    c = int(np.argmax(np.diff(edges)))
    quarter = (edges[c + 1] - edges[c]) // 4
    one = np.random.default_rng(SEED).integers(
        edges[c] + quarter, edges[c + 1] - quarter, len(x))
    one = torch.from_numpy(one).to(x.device)
    if torch.unique(nn_route(one, srv.xb, srv.x_max)[2]).numel() != 1:
        raise AssertionError("the one-chunk batch spans chunks")
    return {"sorted x": torch.sort(x).values, "one chunk": one}


def kernel_device_ms(fn, dev, reps: int = 20) -> float:
    """The card's own milliseconds a call of fn(), whose host work may take
    longer than its kernels: the card sleeps (torch.cuda._sleep) while the
    host enqueues reps calls between two CUDA events, so that the events
    time the calls' kernels back to back and none of the host's work. The
    sleep grows until it outlasts the enqueueing (host clock)."""
    import torch

    fn()
    cycles = 1 << 22
    for _ in range(6):
        torch.cuda.synchronize(dev)
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        t0 = time.perf_counter()
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if slept.elapsed_time(start) > host_ms:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise AssertionError("the card's sleep never outlasted the host's "
                         f"enqueueing of {reps} calls")


def nn_kernel_phase(dev, idx21, sm_clock_mhz: float) -> dict:
    """Phase 3b's NN check on nn_untrained's model: nn_predict_cuda against
    the plain nn_predict on the same CUDA tensors, on phase 5's 1M x and on
    every genome k-mer: every rank equal. Returns, on phase 5's x, the
    kernel's device time a launch (kernel_device_ms), the CUDA-event time
    of a wrapper call and of the plain version, the kernel's launches a
    call and its bound (nn_bound_ms)."""
    import torch

    from sapling_tpu_torch.ops import nn_predict_cuda

    import numpy as np

    srv, kmers = nn_untrained(dev, idx21)
    c = srv.xb.shape[0]
    args, kw = nn_model_args(srv)
    codes, _n_in = query_codes(idx21.codes)
    x5 = idx21.to(dev).query_inputs(codes)[0]
    batches = nn_batches(x5, srv)
    out = dict(chunks=c, units=NN_UNITS, lanes=0)
    for name, x in (("phase 5 x", x5),
                    ("every k-mer", torch.from_numpy(kmers).to(dev)),
                    *batches.items()):
        before = nn_predict_cuda.LAUNCHES["nn_predict"]
        got = nn_predict_cuda.nn_predict_cuda(x, *args, **kw)
        launched = nn_predict_cuda.LAUNCHES["nn_predict"] - before
        want = nn_predict_cuda.nn_predict(x, *args, **kw)
        if not torch.equal(got, want) or launched != 1:
            raise AssertionError(
                f"nn_predict kernel != plain on {name}: "
                f"{int((got != want).sum())} of {len(x)} ranks differ, "
                f"{launched} launches")
        out["lanes"] += len(x)
    out["kmers"] = len(kmers)
    out["ms"] = kernel_device_ms(lambda: nn_predict_cuda.nn_predict_cuda(
        x5, *args, **kw), dev)
    out["batch_ms"] = {
        name: kernel_device_ms(lambda x=x: nn_predict_cuda.nn_predict_cuda(
            x, *args, **kw), dev) for name, x in batches.items()}
    chunks = nn_predict_cuda.nn_route(x5, srv.xb, srv.x_max)[2]
    out["wavefronts"] = nn_shared_wavefronts(
        chunks.cpu().numpy(), NN_UNITS, nn_predict_cuda.kernel_tile())
    out["distinct_chunks_a_warp"] = float(np.mean([
        len(np.unique(w)) for w in np.array_split(
            chunks.cpu().numpy(), -(-len(x5) // 32))]))
    out["call_ms"] = _time_ms(lambda: nn_predict_cuda.nn_predict_cuda(
        x5, *args, **kw), dev)
    out["plain_ms"] = _time_ms(lambda: nn_predict_cuda.nn_predict(
        x5, *args, **kw), dev, reps=3, warm=1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out.update(nn_bound_ms(len(x5), c, NN_UNITS, sm_clock_mhz, sms))
    out["pct_of_bound"] = 100 * out["bound_ms"] / out["ms"]
    return out


def nn_windows(idx) -> dict:
    """Windows as wide as the NN engine's on a 100 Mbp index (hundreds of
    thousands of ranks): a quarter of idx's ranks on each side ('most'),
    half ('max')."""
    quarter = idx.n // 4
    return dict(most_over=quarter, most_under=quarter, max_over=2 * quarter,
                max_under=2 * quarter)


def plquery_inputs(idx, length: int, codes=None, shift: int = 0,
                   ranks: bool = False, fast3: bool = False,
                   sample: int | None = None, **over):
    """A plquery case on `idx` (on the card): query_codes (or `codes`) as
    plquery_batch's arguments (q_words; with `fast3`, where the index has
    prefix3 and the length allows, q3 too, so that the kernel and the
    plain version take the fast3 probe) and keywords (with `shift`, a
    pred64 moved by up to that many ranks, seeded), the kernel's probe
    form (query_cuda.kernel_form), the coalesced bytes a lane reads and
    writes and the index's record tables as plquery_cuda's keywords (made
    here on first use; with `ranks`, rank records made for the case
    whatever the index's size; with `sample`, the rank records' sample of
    one key every 2^sample ranks, ops.query.rank_sample, which the kernel
    asks where the windows are wide enough: the form "sampled key"):
    (args, kw, form, lane_bytes, recs)."""
    import numpy as np
    import torch

    from sapling_tpu_torch.ops import pack as packops
    from sapling_tpu_torch.ops import query, query_cuda
    from sapling_tpu_torch.ops.predict import predict_pwl

    if codes is None:
        codes, _n_in = query_codes(idx.codes, length)
    d = idx.device_arrays()
    x, _q3, q_words = idx.query_inputs(codes)
    if q_words is None:   # an index on the CPU packs q3 for fast3
        q_words = idx.query_words(codes)
    q3 = None
    if fast3 and d["prefix3"] is not None and \
            length <= min(idx.k, packops.P3_BASES):
        q3 = torch.from_numpy(
            packops.pack_queries3(codes).view(np.int64)).to(x.device)
    t = idx.table
    kw = dict(n=idx.n, length=length, k=idx.k, buckets=idx.buckets,
              most_over=t.most_over, most_under=t.most_under,
              max_over=t.max_over, max_under=t.max_under)
    kw.update(over)
    if shift:
        rng = np.random.default_rng(SEED + length)
        pred = predict_pwl(x, d["xlist"], d["ylist"], 2 * idx.k,
                           idx.buckets, idx.n)
        kw["pred64"] = torch.clamp(pred + torch.from_numpy(
            rng.integers(-shift, shift + 1, len(codes))).to(x.device), 0,
            idx.n - 1)
    args = (d["packed"], d["rev"], d["xlist"], d["ylist"], q_words, x,
            d["prefix64"], d["prefix3"], q3, d["bounds"])
    recs = dict(zip(("bucket_recs", "rank_recs"), idx.query_records()))
    if ranks and recs["rank_recs"] is None:
        recs["rank_recs"] = query_cuda.plquery_records_cuda(
            d["packed"], d["rev"], n=idx.n)
    form = query_cuda.kernel_form(length, idx.k, d["prefix3"], q3,
                                  recs["rank_recs"])
    if sample is not None:
        recs.update(rank_sample=query.rank_sample(
            recs["rank_recs"], n=idx.n, shift=sample), sample_shift=sample)
        if form == "key" and query_cuda.samples_probes(
                kw["most_over"], kw["most_under"], sample):
            form = "sampled key"
    lane_bytes = 16 + (8 if form == "fast3" else 8 * q_words.shape[0]) \
        + (8 if shift else 0)
    return args, kw, form, lane_bytes, recs


def query_form(didx, inputs, length: int) -> str:
    """The probe plquery_kernel takes for didx.query_device (an index on
    the card) over `inputs` (its query_inputs): query_cuda.kernel_form."""
    from sapling_tpu_torch.ops import query_cuda

    return query_cuda.kernel_form(length, didx.k,
                                  didx.device_arrays()["prefix3"], inputs[1],
                                  didx.query_records()[1])


def binsearch_inputs(didx, codes):
    """A binary-search case on `didx` (on the card): the query words, the
    keywords and the coalesced bytes a lane reads and writes."""
    qw = didx.query_words(codes)
    return qw, dict(n=didx.n, length=codes.shape[1]), 8 + 8 * qw.shape[0]


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
    _, qlaunch, _ = counted(lambda: aligner.align_fastq(fq, sam,
                                                        cl="chip_smoke"))
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
    _, bare_launch, _ = counted(lambda: bare.align_fastq(
        fq_head, bare_sam, cl="chip_smoke"))
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
                phases=dict(aligner.phase_seconds), bare_seconds=bare_s,
                query_launches=qlaunch, bare_query_launches=bare_launch)


def query_codes(genome_codes, length: int = QUERY_LEN):
    """Seeded query codes [N_QUERIES, length] from a genome's base codes
    (0..3): the first n_in taken from the genome, the last N_QUERIES // 8
    random. Returns (codes, n_in)."""
    import numpy as np

    n_q = N_QUERIES
    rng = np.random.default_rng(SEED + 2)
    n_in = n_q - n_q // 8
    starts = rng.integers(0, len(genome_codes) - length + 1, n_in)
    q = np.concatenate([
        genome_codes[starts[:, None] + np.arange(length)],
        rng.integers(0, 4, (n_q - n_in, length)).astype(np.uint8)])
    return q, n_in


def query_phase(dev, idx21) -> dict:
    """Phase 5: 21-base plquery on `dev`, self-checked, positions held
    against the CPU path on the first N_QUERY_CHECK queries."""
    import numpy as np

    length, n_check = QUERY_LEN, N_QUERY_CHECK
    codes, n_in = query_codes(idx21.codes)
    didx = idx21.to(dev)
    inputs = didx.query_inputs(codes)
    pos, launches, _ = planned(lambda: didx.query_device(*inputs, length))
    pos = pos.cpu().numpy()
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
               random_found=int(ok[n_in:].sum()), pos=pos, launches=launches)
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


def sweep_phase(dev, idx21) -> list[dict]:
    """Phase 6: the length sweep on the k=21 index as built and without
    its prefix arrays; per length and index: probe form, CUDA-event ms,
    q/s, the kernel's launches a call, and the rounds of one call (the
    kernel's stats: ops.query.ROUNDS)."""
    import numpy as np

    from sapling_tpu_torch.ops import query

    indexes = (("built", idx21), ("no_prefix", without_prefix(idx21)))
    rows = []
    for length in SWEEP:
        codes, n_in = query_codes(idx21.codes, length)
        row = {"length": length}
        got = []
        for name, idx in indexes:
            didx = idx.to(dev)
            inputs = didx.query_inputs(codes)
            pos, launches, _ = planned(
                lambda: didx.query_device(*inputs, length))
            pos = pos.cpu().numpy()
            query.ROUNDS.update(C=0, D=0)
            didx.query_device(*inputs, length, stats=True)
            rounds = dict(query.ROUNDS)
            ms = _time_ms(lambda: didx.query_device(*inputs, length), dev,
                          reps=3, warm=1)
            row[name] = dict(form=query_form(didx, inputs, length), ms=ms,
                             qps=N_QUERIES / (ms / 1e3),
                             stride_steps=rounds["C"],
                             bisect_rounds=rounds["D"],
                             launches=launches["plquery"])
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


def baseline_phase(dev, idx21, tables) -> dict:
    """Phase 7: the plain and the llcp/rlcp-pruned binary search on phase
    5's queries, self-checked and held against the CPU path; the pruned
    search's first call (counted) also makes the node records, once: a
    second call launches the search alone, as the timed ones do."""
    codes, n_in = query_codes(idx21.codes)
    didx = idx21.to(dev)
    on_cpu = {"binsearch": lambda c: idx21.query_positions_binsearch(c),
              "fancy": lambda c: idx21.query_positions_fancy(c, *tables)}
    out = {}
    for name, run in baseline_runs(didx, codes, tables).items():
        # the pruned search's first call makes the index's node records
        pos, launches, _ = counted(run, want=name)
        if name == "fancy":
            _, again, _ = counted(run, want=name)
            if launches["fancy_nodes"] != 1 or again["fancy_nodes"]:
                raise AssertionError(
                    f"the node records were not built once: {launches}, "
                    f"then {again}")
        pos = pos.cpu().numpy()
        _check(name, pos, didx.verify_hits(codes, pos), n_in,
               on_cpu[name](codes[:N_QUERY_CHECK]))
        ms = _time_ms(run, dev, reps=3, warm=1)
        out[name] = dict(ms=ms, qps=N_QUERIES / (ms / 1e3),
                         launches=launches)
    return out


def start_scale_build(workdir: str):
    """Phase 2's chromosome-scale build, started in the background before
    CUDA starts: the port's build_big_index (fork workers on the host)
    at SCALE_N, then its retable_index to SCALE_RETABLE_NB (table only),
    in one child shell whose log goes to workdir. Returns
    (process, artifact, table, log path)."""
    art = os.path.join(workdir, "scale.stpu.npz")
    table = os.path.join(workdir, f"scale_nb{SCALE_RETABLE_NB}.table.npz")
    workers = f"workers={min(8, os.cpu_count() or 1)}"
    tool = [sys.executable, "-m", "sapling_tpu_torch.tools."]
    build = [*tool[:2], tool[2] + "build_big_index", f"n={SCALE_N}",
             f"k={QUERY_LEN}", f"nb={SCALE_NB}", "bounds=1", "stage=0",
             workers, f"out={art}"]
    retable = [*tool[:2], tool[2] + "retable_index", art,
               f"nb={SCALE_RETABLE_NB}", workers, f"out={table}"]
    path = os.path.join(workdir, "scale_build.log")
    with open(path, "w") as logf:
        proc = subprocess.Popen(
            ["sh", "-c", f"{shlex.join(build)} && {shlex.join(retable)}"],
            cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT,
            start_new_session=True)         # main kills the whole group
    return proc, art, table, path


def finish_scale_build(build) -> None:
    """Wait for start_scale_build's child; fail with its log's end."""
    proc, _art, _table, path = build
    if proc.wait() != 0:
        with open(path) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"scale build failed (rc {proc.returncode}):\n"
                           f"{tail}")


def scale_phase(dev, art: str, table_path: str) -> dict:
    """Phase 8: the SCALE_N artifact loaded memory-mapped without the
    members a query never reads (its codes copied into RAM, as
    bench_query_scale loads it), SCALE_LENGTHS queries on `dev` with the
    artifact's own table and then, after swap_table, with the retabled
    one; every in-genome query self-checks and the first N_QUERY_CHECK
    positions equal the CPU path's; the first query makes the index's
    record tables (its launches are kept: one plquery_records); rev,
    packed and the rank records stay the same tensors across the swap, the
    bucket records are made anew."""
    import torch

    from sapling_tpu_torch.tools.bench_query_scale import load_for_queries
    from sapling_tpu_torch.tools.retable_index import load_table

    didx = load_for_queries(art, dev)
    host = didx.to("cpu")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    arrays = didx.device_arrays()
    torch.cuda.synchronize(dev)
    out = dict(n=didx.n, send_s=time.perf_counter() - t0, rows=[], pos={})
    ptrs = {f: arrays[f].data_ptr() for f in ("rev", "packed")}
    for name, table in (("own", None),
                        ("retable", load_table(table_path, didx.n, didx.k))):
        if table is not None:
            didx.swap_table(table)
            host.swap_table(table)
            now = dict(didx.device_arrays(),
                       **{"rank records": didx.query_records()[1]})
            moved = [f for f, p in ptrs.items() if now[f].data_ptr() != p]
            if moved:
                raise AssertionError(f"swap_table moved {moved}")
            if didx.query_records()[0].shape[0] != 1 << table.buckets:
                raise AssertionError("swap_table kept the old bucket records")
        for length in SCALE_LENGTHS:
            codes, n_in = query_codes(didx.codes, length)
            inputs = didx.query_inputs(codes)
            pos, launches, _ = planned(
                lambda: didx.query_device(*inputs, length))
            # the first query made the index's record tables
            out.setdefault("launches", launches)
            ptrs.setdefault("rank records",
                            didx.query_records()[1].data_ptr())
            pos = pos.cpu().numpy()
            ok = didx.verify_hits(codes, pos)
            tag = f"2^{didx.buckets} L={length}"
            _check(tag, pos, ok, n_in,
                   host.query_positions(codes[:N_QUERY_CHECK]))
            if table is None:
                out["pos"][length] = pos
            ms = _time_ms(lambda: didx.query_device(*inputs, length), dev,
                          reps=3, warm=1)
            out["rows"].append(dict(table=name, buckets=didx.buckets,
                                    length=length, ms=ms,
                                    qps=N_QUERIES / (ms / 1e3),
                                    self_check=int(ok[:n_in].sum()),
                                    in_genome=n_in,
                                    launches=launches["plquery"]))
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["device_bytes"] = didx.device_bytes()
    if out["launches"]["plquery_records"] != 1:
        raise AssertionError(f"the {didx.n} bp index's first query did not "
                             f"make its rank records: {out['launches']}")
    return out


def _predict_all(srv, kmers):
    """srv's predicted ranks for every k-mer, in NN_BATCH batches on srv's
    device, as one host array."""
    import numpy as np
    import torch

    out = []
    with torch.no_grad():
        for lo in range(0, len(kmers), NN_BATCH):
            x = torch.from_numpy(kmers[lo:lo + NN_BATCH]).to(srv.device)
            out.append(srv.predict_ranks(x).cpu().numpy())
    return np.concatenate(out)


def nn_train_parity(dev) -> dict:
    """Phase 9's training check: test_models.py's corpus (8 kbp, k=11, 4
    chunks of 8 units, 200 epochs, window 60) fitted on the card and on the
    CPU from one set of initial parameters; the stop epochs must be equal
    and the loss histories within NN_TRAIN_RTOL."""
    import numpy as np
    import torch

    from sapling_tpu_torch.config import IndexConfig
    from sapling_tpu_torch.index.sapling import SaplingIndex
    from sapling_tpu_torch.models import residual
    from sapling_tpu_torch.ops.pack import kmers_scan
    from sapling_tpu_torch.sim.genomes import uniform_genome

    idx = SaplingIndex.build(uniform_genome(8000, seed=5),
                             IndexConfig(k=11, buckets=6), device="cpu")
    kmers = kmers_scan(idx.codes, 11)
    ds = residual.prepare_dataset(kmers, np.asarray(idx.inv[:len(kmers)]), 4)
    init = residual.params_to_numpy(residual.init_params(
        torch.Generator().manual_seed(0), 4, 8, device="cpu"))
    runs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        tr = residual.Trainer.from_params(residual.params_from_numpy(init, d))
        t0 = time.perf_counter()
        hist = tr.fit(ds, epochs=200, convergence_window=60)
        runs[name] = (hist, tr.stop_epochs, time.perf_counter() - t0)
    (h_card, s_card, t_card), (h_cpu, s_cpu, t_cpu) = runs["card"], runs["cpu"]
    if not np.array_equal(s_card, s_cpu):
        raise AssertionError(f"training stop epochs differ: card {s_card}, "
                             f"CPU {s_cpu}")
    np.testing.assert_allclose(h_card, h_cpu, rtol=NN_TRAIN_RTOL, atol=0)
    return dict(stops=s_card.tolist(), epochs=len(h_card),
                max_rel=float(np.max(np.abs(h_card - h_cpu) / h_cpu)),
                card_s=t_card, cpu_s=t_cpu)


def nn_phase(dev, idx21) -> dict:
    """Phase 9: the NN predictor on the k=21 index on `dev`. Trains the
    residual family at bench_nn_query's width (train_serving, NN_CHUNKS x
    NN_UNITS, NN_EPOCHS, seed 0) and audits it; every genome k-mer's
    predicted rank must equal the same model's on the CPU and the audit's
    errors must lie inside the windows; NNQueryEngine answers phase 5's
    queries (every in-genome one self-checks, the first N_QUERY_CHECK
    equal the CPU path's with the same model) from one nn_predict and one
    plquery launch, and is timed in turns with the PWL engine on the same
    inputs (NN then PWL, three times; the median of each engine's three
    timings), and predict_ranks alone (the kernel) in turns with the
    plain nn_predict on the card; then the training check of
    nn_train_parity."""
    import numpy as np

    from sapling_tpu_torch.models.serve import (NNQueryEngine, audit_serving,
                                                train_serving)
    from sapling_tpu_torch.ops import query
    from sapling_tpu_torch.ops.nn_predict_cuda import nn_predict
    from sapling_tpu_torch.ops.pack import kmers_scan

    didx = idx21.to(dev)
    lines = []
    t0 = time.perf_counter()
    srv = train_serving(didx, num_chunks=NN_CHUNKS, layer_size=NN_UNITS,
                        epochs=NN_EPOCHS, seed=0, log=lines.append)
    out = dict(train_audit_s=time.perf_counter() - t0, trained=lines[-1],
               windows=(srv.most_over, srv.most_under, srv.max_over,
                        srv.max_under),
               params=[{k: v.cpu().numpy() for k, v in layer.items()}
                       for layer in srv.params])
    t0 = time.perf_counter()
    audit = audit_serving(srv, didx)
    out["audit_s"] = time.perf_counter() - t0
    err = audit.errors
    if srv.max_over < int(err.max(initial=0)) or \
            srv.max_under < int(-err.min(initial=0)):
        raise AssertionError(f"audit errors outside the windows {out}")

    kmers = kmers_scan(idx21.codes, idx21.k)
    host = srv.to("cpu")
    t0 = time.perf_counter()
    card = _predict_all(srv, kmers)
    want = _predict_all(host, kmers)
    if not np.array_equal(card, want):
        raise AssertionError(f"{int((card != want).sum())} of {len(kmers)} "
                             "predicted ranks differ between the card and "
                             "the CPU")
    out.update(n_kmers=len(kmers), ranks_s=time.perf_counter() - t0)

    codes, n_in = query_codes(idx21.codes)
    eng = NNQueryEngine(didx, srv)
    inputs = didx.query_inputs(codes)
    nn_inputs = eng.query_inputs(codes)   # the fast3 probe's q3
    pos, launches, _ = counted(lambda: eng.query_device(*nn_inputs))
    if (launches["nn_predict"], launches["plquery"]) != (1, 1):
        raise AssertionError(f"NN engine call launched {launches}, not one "
                             "nn_predict and one plquery")
    pos = pos.cpu().numpy()
    query.ROUNDS.update(C=0, D=0)
    eng.query_device(*nn_inputs, stats=True)
    nn_rounds = query.ROUNDS["D"]
    query.ROUNDS.update(C=0, D=0)
    didx.query_device(*inputs, QUERY_LEN, stats=True)
    pwl_rounds = query.ROUNDS["D"]
    _check("NN engine", pos, didx.verify_hits(codes, pos), n_in,
           NNQueryEngine(idx21, host).query_positions(codes[:N_QUERY_CHECK]))
    runs = {"nn": lambda: eng.query_device(*nn_inputs),
            "pwl": lambda: didx.query_device(*inputs, QUERY_LEN)}
    times = {name: [] for name in runs}
    for _ in range(3):
        for name, fn in runs.items():
            times[name].append(_time_ms(fn, dev, reps=5, warm=1))
    ms, pwl_ms = (float(np.median(times[name])) for name in runs)
    # predict_ranks alone: the kernel in turns with the plain version
    args, kw = nn_model_args(srv)
    runs = {"kernel": lambda: srv.predict_ranks(inputs[0]),
            "plain": lambda: nn_predict(inputs[0], *args, **kw)}
    ptimes = {name: [] for name in runs}
    for _ in range(3):
        for name, fn in runs.items():
            ptimes[name].append(_time_ms(fn, dev, reps=5, warm=1))
    out.update(predict_ms=float(np.median(ptimes["kernel"])),
               predict_plain_ms=float(np.median(ptimes["plain"])))
    out.update(ms=ms, pwl_ms=pwl_ms, qps=N_QUERIES / (ms / 1e3),
               pwl_qps=N_QUERIES / (pwl_ms / 1e3), nn_rounds=nn_rounds,
               pwl_rounds=pwl_rounds, ratio=pwl_ms / ms, in_genome=n_in,
               launches=launches)
    out["train_parity"] = nn_train_parity(dev)
    return out


def _p10_inputs(td: str) -> dict:
    """Phase 10's inputs, as multi_rank_phase saved them to `td`."""
    import numpy as np

    with np.load(os.path.join(td, "p10_pos.npz")) as z:
        pos = {k: z[k] for k in z.files}
    with np.load(os.path.join(td, "p10_nn.npz")) as z:
        nn = [{"w": z[f"p{i}_w"], "b": z[f"p{i}_b"]}
              for i in range(len(z.files) // 2)]
    return dict(pos=pos, nn=nn, idx21=os.path.join(td, "p10_idx21.stpu.npz"),
                idx16=os.path.join(td, "p10_idx16.stpu.npz"),
                scale=os.path.join(td, "scale.stpu.npz"))


def _engine_run(name, eng, codes, want, dev, reps):
    """One engine's checked query_positions (positions equal to `want`),
    the collectives it issued (parallel.mesh.COLLECTIVES), and the
    CUDA-event time of its query_device on this rank's prepared lanes
    (reps calls after a warm one; every rank of the world calls it
    alike)."""
    import numpy as np

    from sapling_tpu_torch.parallel.mesh import COLLECTIVES

    COLLECTIVES.update(all_reduce=0, all_gather=0)
    pos = eng.query_positions(codes)
    coll = sum(COLLECTIVES.values())
    if not np.array_equal(pos, want):
        raise AssertionError(f"{name}: {int((pos != want).sum())} positions "
                             "differ from the single-device phase's")
    x, q3, q_words, _b = eng.query_inputs(codes)
    length = int(codes.shape[1])
    ms = _time_ms(lambda: eng.query_device(x, q3, q_words, length), dev,
                  reps=reps, warm=1)
    return pos, dict(ms=ms, lanes=len(x), collectives=coll)


def _p10_world1(rank, world, td):
    """Phase 10, world 1 over NCCL: both engines on phase 5's queries and
    on phase 8's artifact at SCALE_LENGTHS, equal to those phases'
    positions; the single-device index's query_positions timed the same
    way beside them."""
    import torch
    import torch.distributed as dist

    from sapling_tpu_torch.index.sapling import SaplingIndex
    from sapling_tpu_torch.parallel.mesh import make_mesh
    from sapling_tpu_torch.parallel.query import ShardedQueryEngine
    from sapling_tpu_torch.parallel.sharded_index import IndexShardedEngine
    from sapling_tpu_torch.tools.bench_query_scale import load_for_queries

    if dist.get_backend() != "nccl":
        raise AssertionError(f"world 1 runs {dist.get_backend()}, not nccl")
    dev = torch.device("cuda", torch.cuda.current_device())
    inp = _p10_inputs(td)
    mesh = make_mesh(1, device=dev)
    imesh = make_mesh(1, axes=("dp", "idx"), device=dev)
    idx21 = SaplingIndex.load(inp["idx21"], device=dev)
    big = load_for_queries(inp["scale"], dev)
    runs = [(5, idx21, QUERY_LEN, inp["pos"]["phase5"])]
    runs += [(8, big, n, inp["pos"][f"scale{n}"]) for n in SCALE_LENGTHS]
    out = []
    for phase, idx, length, want in runs:
        tag = f"{idx.n} bp L={length}"
        codes, _n_in = query_codes(idx.codes, length)
        row = dict(phase=phase, length=length, tag=tag)
        for name, eng in (("dp", ShardedQueryEngine(idx, mesh)),
                          ("idx", IndexShardedEngine(idx, imesh))):
            row[name] = _engine_run(f"world 1 {name} {tag}", eng, codes,
                                    want, dev, reps=3)[1]
        inputs = idx.query_inputs(codes)
        ms = _time_ms(lambda: idx.query_device(*inputs, length), dev,
                      reps=3, warm=1)
        row["single"] = dict(ms=ms, lanes=len(codes))
        out.append(row)
    return out


def _p10_world2(rank, world, td):
    """Phase 10, two ranks on the one card over gloo: IndexShardedEngine at
    idx=2 on phase 8's artifact, ShardedQueryEngine at dp=2 on phase 5's
    queries, error_histogram of their prediction errors,
    align_fastq_multihost on phase 4's reads, one shard_for_mesh step of
    phase 9's family at dp=1, tp=2."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sapling_tpu_torch.index.sapling import SaplingIndex
    from sapling_tpu_torch.models import residual
    from sapling_tpu_torch.ops import sw_cuda
    from sapling_tpu_torch.ops.pack import kmers_scan
    from sapling_tpu_torch.ops.predict import predict_pwl
    from sapling_tpu_torch.parallel.mesh import make_mesh
    from sapling_tpu_torch.parallel.multihost import align_fastq_multihost
    from sapling_tpu_torch.parallel.query import (ShardedQueryEngine,
                                                  error_histogram)
    from sapling_tpu_torch.parallel.sharded_index import IndexShardedEngine
    from sapling_tpu_torch.tools.bench_query_scale import load_for_queries

    if dist.get_backend() != "gloo":
        raise AssertionError(f"two ranks run {dist.get_backend()}")
    dev = torch.device("cuda", 0)
    inp = _p10_inputs(td)
    out = {"rank": rank}

    big = load_for_queries(inp["scale"], dev)
    ieng = IndexShardedEngine(
        big, make_mesh(2, tp=2, axes=("dp", "idx"), device=dev))
    for length in SCALE_LENGTHS:
        codes, n_in = query_codes(big.codes, length)
        pos, out[f"idx2 L={length}"] = _engine_run(
            f"idx=2 L={length}", ieng, codes, inp["pos"][f"scale{length}"],
            dev, reps=1)
        ok = big.verify_hits(codes, pos)
        if not ok[:n_in].all():
            raise AssertionError(f"idx=2 L={length}: "
                                 f"{int((~ok[:n_in]).sum())} in-genome "
                                 "queries failed self-check")
    del big, ieng

    idx21 = SaplingIndex.load(inp["idx21"], device=dev)
    mesh = make_mesh(2, device=dev)
    codes, _n_in = query_codes(idx21.codes)
    pos, out["dp2"] = _engine_run("dp=2", ShardedQueryEngine(idx21, mesh),
                                  codes, inp["pos"]["phase5"], dev, reps=1)
    # the prediction errors of the found lanes: predicted - true rank
    d = idx21.device_arrays()
    x = torch.from_numpy(idx21.kmerize_batch(codes)).to(dev)
    pred = predict_pwl(x, d["xlist"], d["ylist"], 2 * idx21.k,
                       idx21.buckets, idx21.n).cpu().numpy()
    found = pos >= 0
    errors = pred[found] - idx21.inv[pos[found]].astype(np.int64)
    hist = error_histogram(errors, mesh, nbins=64)
    lo, hi = int(errors.min()), int(errors.max()) + 1
    width = max(1, (hi - lo + 63) // 64)
    ref = np.bincount(np.clip((errors - lo) // width, 0, 63), minlength=64)
    if not np.array_equal(hist, ref):
        raise AssertionError("error_histogram differs from numpy's bincount")
    out["hist"] = dict(n=len(errors), lo=lo, hi=hi, width=width,
                       bin0=int(hist[0]))

    # one shard_for_mesh step of phase 9's family, against a one-rank step
    tmesh = make_mesh(2, tp=2, device=dev)
    kmers = kmers_scan(idx21.codes, idx21.k)
    ds = residual.prepare_dataset(
        kmers, np.asarray(idx21.inv[:len(kmers)], np.int64), NN_CHUNKS)
    tr = residual.Trainer.from_params(residual.params_from_numpy(inp["nn"],
                                                                 dev))
    x, y, v = residual.shard_for_mesh(tr, ds, tmesh)
    loss = float(tr.train_step(x, y, v, tp=tmesh.groups["tp"],
                               dp=tmesh.groups["dp"]))
    one = residual.Trainer.from_params(residual.params_from_numpy(inp["nn"],
                                                                  dev))
    one_loss = float(one.train_step(ds.x, ds.res, ds.valid))
    w = NN_UNITS // 2
    cols = slice(rank * w, (rank + 1) * w)
    worst = abs(loss - one_loss)
    with torch.no_grad():
        for mine, whole, last in zip(tr.params, one.params, (False, True)):
            want = ({"w": whole["w"][:, cols, :], "b": whole["b"]} if last
                    else {"w": whole["w"][:, :, cols],
                          "b": whole["b"][:, cols]})
            for key in ("w", "b"):
                worst = max(worst,
                            float((mine[key] - want[key]).abs().max()))
    if worst > MULTI_TRAIN_ATOL:
        raise AssertionError(f"shard_for_mesh step {worst:.3e} from the "
                             "one-rank step")
    out["train"] = dict(loss=loss, worst=worst)

    idx16 = SaplingIndex.load(inp["idx16"], device=dev)
    sam = os.path.join(td, "p10_multi.sam")
    for k in sw_cuda.LAUNCHES:
        sw_cuda.LAUNCHES[k] = 0
    dist.barrier()
    t0 = time.perf_counter()
    align_fastq_multihost(idx16, os.path.join(td, "reads.fq"), sam,
                          cl="chip_smoke", work_dir=os.path.join(td, "p10"),
                          device=dev)
    out["align_s"] = time.perf_counter() - t0
    out["launches"] = dict(sw_cuda.LAUNCHES)
    if rank == 0:
        with open(sam, "rb") as f, \
                open(os.path.join(td, "dev.sam"), "rb") as g:
            if f.read() != g.read():
                raise AssertionError("the 2-rank SAM differs from phase 4's")
    return out


def multi_rank_phase(td: str, idx16, idx21, qr, sc, nn) -> dict:
    """Phase 10: save what the ranks load, then world 1 over NCCL and two
    ranks on the one card over gloo, each world in spawned children."""
    import numpy as np

    from sapling_tpu_torch.parallel.multihost import spawn_ranks

    t0 = time.perf_counter()
    idx21.save(os.path.join(td, "p10_idx21.stpu.npz"))
    idx16.save(os.path.join(td, "p10_idx16.stpu.npz"))
    np.savez(os.path.join(td, "p10_pos.npz"), phase5=qr["pos"],
             **{f"scale{n}": p for n, p in sc["pos"].items()})
    np.savez(os.path.join(td, "p10_nn.npz"), **{
        f"p{i}_{k}": layer[k] for i, layer in enumerate(nn["params"])
        for k in ("w", "b")})
    save_s = time.perf_counter() - t0
    one = spawn_ranks(_p10_world1, 1, f"file://{td}/p10_rendezvous1",
                      "nccl", args=(td,), timeout=MULTI_TIMEOUT)[0]
    t1 = time.perf_counter()
    two = spawn_ranks(_p10_world2, 2, f"file://{td}/p10_rendezvous2",
                      "gloo", args=(td,), timeout=MULTI_TIMEOUT)
    return dict(world1=one, world2=two, save_s=save_s,
                world1_s=t1 - t0 - save_s, world2_s=time.perf_counter() - t1,
                seconds=time.perf_counter() - t0)


def _p10_log(p10, qr, sc) -> None:
    """Phase 10's lines. Times are each engine's query_device on the
    rank's prepared lanes (CUDA events); q/s counts the whole batch over
    the slowest rank's time (`shared`: every rank runs the same lanes)."""
    def rate(rows, key, shared=False):
        ms = max(r[key]["ms"] for r in rows)
        lanes = (rows[0][key]["lanes"] if shared
                 else sum(r[key]["lanes"] for r in rows))
        per_rank = " / ".join(f"{r[key]['ms']:.3f}" for r in rows)
        coll = rows[0][key].get("collectives")
        return (f"{per_rank} ms = {lanes / (ms / 1e3):.1f} q/s"
                + ("" if coll is None else f", {coll} collectives a call"))

    own = {r["length"]: r for r in sc["rows"] if r["table"] == "own"}
    for row in p10["world1"]:
        base = qr if row["phase"] == 5 else own[row["length"]]
        log(f"multi-rank world 1 (nccl) {row['tag']}: dp engine "
            f"{rate([row], 'dp')}; idx engine {rate([row], 'idx')}; the "
            f"single-device index in turns {rate([row], 'single')}, in "
            f"phase {row['phase']} {base['ms']:.3f} ms; positions equal to "
            f"phase {row['phase']}'s")
    r0, r1 = p10["world2"]
    for length in SCALE_LENGTHS:
        log(f"multi-rank 2 ranks on one card (gloo) idx=2 {SCALE_N} bp "
            f"L={length}: ranks 0 / 1 "
            f"{rate([r0, r1], f'idx2 L={length}', shared=True)}; positions "
            "equal to phase 8's, every in-genome query self-checked")
    log(f"multi-rank 2 ranks (gloo) dp=2 {GENOME_N} bp L={QUERY_LEN}: "
        f"ranks 0 / 1 {rate([r0, r1], 'dp2')}; positions equal to phase "
        "5's")
    h = r0["hist"]
    log(f"multi-rank 2 ranks (gloo) error_histogram of {h['n']} prediction "
        f"errors in [{h['lo']}, {h['hi']}) (64 bins of {h['width']}): equal "
        "to numpy's bincount")
    worst = max(r0["train"]["worst"], r1["train"]["worst"])
    log(f"multi-rank 2 ranks (gloo) shard_for_mesh dp=1 tp=2 step of phase "
        f"9's family ({NN_CHUNKS} x {NN_UNITS}): loss {r0['train']['loss']!r}"
        f", loss and parameters within {worst:.2e} of a one-rank step "
        f"(limit {MULTI_TRAIN_ATOL:g})")
    slowest = max(r0["align_s"], r1["align_s"])
    log(f"multi-rank 2 ranks (gloo) align_fastq_multihost: {N_READS} reads "
        f"in {slowest:.3f} s = {N_READS / slowest:.1f} reads/s; merged SAM "
        f"byte-identical to phase 4's; SW launches rank 0 {r0['launches']}, "
        f"rank 1 {r1['launches']}")
    log(f"multi-rank: phase 10 took {p10['seconds']:.1f} s (saving the "
        f"inputs {p10['save_s']:.1f} s, world 1 {p10['world1_s']:.1f} s, "
        f"two ranks {p10['world2_s']:.1f} s)")


def profiling_phase(dev, idx21, workdir: str) -> dict:
    """Phase 11's profiling: utils.profiling.profile_trace around one
    phase-5 query call (the Chrome trace must exist and hold CUDA kernel
    events), then bench_fn on the same call."""
    from sapling_tpu_torch.utils.profiling import bench_fn, profile_trace

    codes, _n_in = query_codes(idx21.codes)
    didx = idx21.to(dev)
    inputs = didx.query_inputs(codes)
    didx.query_device(*inputs, QUERY_LEN)
    with profile_trace(os.path.join(workdir, "trace")) as tr:
        didx.query_device(*inputs, QUERY_LEN)
    if not os.path.exists(tr["path"]) or tr["kernels"] == 0:
        raise AssertionError(f"no CUDA kernel event in the trace {tr}")
    best, _pos = bench_fn(didx.query_device, *inputs, QUERY_LEN)
    return dict(kernels=tr["kernels"], trace_bytes=os.path.getsize(
        tr["path"]), bench_ms=best * 1e3)


def evalx_phase(seq, idx21, workdir: str, al: dict) -> dict:
    """Phase 11's evalx, on the host: compare_sam of phase 4's SAM against
    truth records of the simulation's positions (its good, bad and
    unaligned counts must be phase 4's near, aligned - near and
    N_READS - aligned), the k-mer spectrum of the genome's LCP at k = 16
    and 21 (the distinct 21-mers must be np.unique's count), and
    per_bin_errors' p95 on the k=21 index's error audit."""
    import numpy as np

    from sapling_tpu_torch.evalx.alignment_quality import (compare_sam,
                                                           truth_sam_lines)
    from sapling_tpu_torch.evalx.bins import per_bin_errors
    from sapling_tpu_torch.evalx.kmer_stats import kmer_spectrum
    from sapling_tpu_torch.index.pwl import error_audit
    from sapling_tpu_torch.index.suffix_array import build_suffix_data
    from sapling_tpu_torch.ops.pack import kmers_scan
    from sapling_tpu_torch.sim.genomes import simulate_reads

    _reads, true_pos, _rc = simulate_reads(seq, N_READS, READ_LEN,
                                           sub_rate=0.01, seed=SEED + 1)
    truth = truth_sam_lines([f"read{i + 1}" for i in range(N_READS)],
                            ["bench"] * N_READS, true_pos)
    rep = compare_sam(os.path.join(workdir, "dev.sam"), truth)
    got = (rep.good, rep.bad, rep.unaligned, rep.missing)
    want = (al["near"], al["aligned"] - al["near"], N_READS - al["aligned"],
            0)
    if got != want:
        raise AssertionError(f"compare_sam (good, bad, unaligned, missing) "
                             f"{got} != phase 4's {want}")
    t0 = time.perf_counter()
    suffix = build_suffix_data(seq, np.int32)
    spec = kmer_spectrum(suffix.lcp, GENOME_N, max_k=idx21.k)
    t = idx21.table
    kmers = kmers_scan(idx21.codes, idx21.k)
    distinct = len(np.unique(kmers))
    if spec["distinct"][idx21.k - 1] != distinct:
        raise AssertionError(f"kmer_spectrum: {spec['distinct'][-1]} "
                             f"distinct {idx21.k}-mers, np.unique "
                             f"{distinct}")
    audit = error_audit(kmers, suffix.inv, suffix.lcp, t.xlist, t.ylist,
                        idx21.k, idx21.buckets, idx21.n)
    # the statistics at 2^EVALX_BINS bins: per_bin_stats takes one
    # np.median a non-empty bin, ~40 s over the table's 2^22
    stats = per_bin_errors(audit, kmers, idx21.k, EVALX_BINS)
    if int(stats["count"].sum()) != len(kmers):
        raise AssertionError("per_bin_errors does not count every k-mer")
    return dict(quality=got, seconds=time.perf_counter() - t0,
                spectrum={k: (int(spec["distinct"][k - 1]),
                              int(spec["unique"][k - 1]),
                              int(spec["total"][k - 1])) for k in (16, 21)},
                p95=stats["p95"], max_abs=int(np.abs(audit.errors).max()))


def last_modules_phase(dev, seq, idx21, td, al) -> None:
    """Phase 11, logged line by line."""
    from sapling_tpu_torch.tools.microbench_gather import MODES, run_modes

    t0 = time.perf_counter()
    pr = profiling_phase(dev, idx21, td)
    log(f"profiling: profile_trace of one {N_QUERIES}-query L={QUERY_LEN} "
        f"call: {pr['kernels']} CUDA kernel events in the Chrome trace "
        f"({pr['trace_bytes']} bytes); bench_fn {pr['bench_ms']:.3f} ms "
        "(min of 3 fenced calls)")
    ev = evalx_phase(seq, idx21, td, al)
    good, bad, unal, _miss = ev["quality"]
    log(f"evalx: compare_sam of phase 4's SAM against the simulation's "
        f"truth: good {good}, bad {bad}, unaligned {unal} (phase 4: near "
        f"{al['near']} of {al['aligned']} aligned); kmer_spectrum "
        + ", ".join(f"k={k}: {d} distinct, {u} unique of {t}"
                    for k, (d, u, t) in ev["spectrum"].items())
        + f"; per_bin_errors of the 2^{idx21.buckets}-bucket table's audit"
        f" at k={idx21.k} in 2^{EVALX_BINS} bins: p95 |error| "
        f"{ev['p95']:.1f}, max {ev['max_abs']}; "
        f"{ev['seconds']:.1f} s")
    # the gather microbenchmark, every mode, each operand freed before
    # the next
    run_modes(GATHER_N, GATHER_LANES, GATHER_ITERS, MODES, (GATHER_GB,),
              dev, log=lambda m: log(f"gather: {m}"))
    for lanes in GATHER_SWEEP_LANES:
        run_modes(GATHER_N, lanes, GATHER_ITERS, ("randref",), (GATHER_GB,),
                  dev, log=lambda m, n=lanes: log(f"gather {n} lanes: {m}"))
    log(f"last modules: phase 11 took {time.perf_counter() - t0:.1f} s")


def build_kernels() -> dict:
    """Every kernel source of the port built at once, one nvcc each:
    {source: seconds}."""
    from concurrent.futures import ThreadPoolExecutor

    from sapling_tpu_torch.ops import nn_predict_cuda, query_cuda, sw_cuda

    def build(src):
        t0 = time.perf_counter()
        sw_cuda.build_kernel(src)
        return time.perf_counter() - t0

    srcs = (sw_cuda.SOURCE, query_cuda.SOURCE, nn_predict_cuda.SOURCE)
    with ThreadPoolExecutor(len(srcs)) as pool:
        return dict(zip((os.path.relpath(s, ROOT) for s in srcs),
                        pool.map(build, srcs)))


def run_phases(td: str, scale, sm_clock_mhz: float):
    """Phases 2 (after start_scale_build) to 11 in `td`; each logs its
    line. Returns phase 3's and 3b's kernel results, phase 4's aligner
    results and phases 5, 7 and 9, which the kernels line reads."""
    import torch

    t0 = time.perf_counter()
    seq, idx16, idx21, tables = build_indexes(GENOME_N)
    log(f"build: {GENOME_N} bp genome, k=16 and k=21 indexes and the "
        "llcp/rlcp tables on the host "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    built = build_kernels()
    log(f"build: the kernels (nvcc sm_90a, in parallel) in "
        f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{s} {sec:.1f} s" for s, sec in built.items()))
    t0 = time.perf_counter()
    finish_scale_build(scale)
    with open(scale[3]) as f:
        totals = [ln.split("TOTAL ")[1].strip() for ln in f if "TOTAL " in ln]
    log(f"build: {SCALE_N} bp artifact, k={QUERY_LEN} 2^{SCALE_NB} buckets "
        f"with bounds, no prefix arrays (build_big_index, TOTAL "
        f"{totals[0]}), and its 2^{SCALE_RETABLE_NB} table (retable_index, "
        f"TOTAL {totals[1]}), beside the builds above; waited "
        f"{time.perf_counter() - t0:.1f} s more for it")
    dev = torch.device("cuda", 0)

    # 3. kernel vs plain on the card
    kp = kernel_vs_plain(dev, sm_clock_mhz)
    sweep = kp["score_only"][f"b{SW_SWEEP}"]
    tiled = {m: kp[m].pop(f"w{SW_TILED_W}") for m in ("full", "score_only")}
    key64 = kp["full"].pop("key64")
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
            f"({t['pct_of_bound']:.1f}%)" for m, t in tiled.items())
        + f"; full mode past the int32 key (int64 key) at B={key64['pairs']}"
        f" W=R={key64['w']} match={SW_KEY64_MATCH}, best score "
        f"{key64['best']}: all fields equal")

    # 3b. the query kernels vs the plain cascade on the card
    t0 = time.perf_counter()
    qk, fnodes, recs, rate, big_recs = query_kernel_phase(
        dev, idx21, scale[1], tables)
    nk = nn_kernel_phase(dev, idx21, sm_clock_mhz)
    log(f"query kernel vs plain: phase 3b took "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"query kernel vs plain: the card's random 32-byte sector rate, a "
        f"torch gather of {rate['lanes']} random int64 of "
        f"{SECTOR_RATE_ELEMS} ({rate['distinct']} distinct sectors) in "
        f"{rate['ms']:.4f} ms: {rate['sectors_per_s'] / 1e9:.2f}G sectors/s "
        "(the second bound of each case)")
    for r in qk:
        log(f"query kernel vs plain: {r['kernel']} {r['name']}: "
            f"{N_QUERIES} lanes equal, rounds {r['rounds']} equal; kernel "
            f"{r['ms']:.4f} ms ({r['launches']} launch), plain "
            f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['distinct']} distinct sectors of 32 B of {r['sectors']} "
            f"the lanes touched, {r['over']} lanes past {QK_TRACE}; "
            f"{r['probes']} probes"
            + (f", {r['decided']} decided by the rank sample" if r["decided"]
               else "")
            + f"; {r['pct_of_bound']:.1f}% of it), at the "
            f"measured sector rate {r['rate_bound_ms']:.4f} ms "
            f"({r['pct_of_rate_bound']:.1f}% of it); lane "
            f"utilisation {100 * r['util']:.1f}%"
            + (f"; {r['sectors'] / N_QUERIES:.2f} sectors read a lane: node"
               " records and genome windows" if r["kernel"] == "fancy"
               else ""))
    for name, r in recs.items():
        log(f"query kernel vs plain: {name}, plquery's record table of the "
            f"k=21 index: {r['rows']} records ({r['bytes']} bytes) equal to "
            f"the plain version; build kernel {r['ms']:.4f} ms (1 launch), "
            f"plain {r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['pct_of_bound']:.1f}% of it)")
    log(f"query kernel vs plain: fancy_nodes, the pruned search's node "
        f"records of the k=21 index: {fnodes['n']} records "
        f"({fnodes['bytes']} bytes) equal to the plain version; build "
        f"kernel {fnodes['ms']:.4f} ms (1 launch), plain "
        f"{fnodes['plain_ms']:.3f} ms; bound {fnodes['bound_ms']:.4f} ms "
        f"({fnodes['pct_of_bound']:.1f}% of it)")
    for name in ("fancy_nodes", "fancy_nodes_copied", "plquery_records",
                 "bucket_records"):
        r = big_recs[name]
        log(f"query kernel vs plain: {name} of phase 8's {SCALE_N} bp "
            f"artifact" + (f" (its llcp / rlcp tables on the host in "
                           f"{big_recs['tables_s']:.1f} s)"
                           if name == "fancy_nodes" else
                           " (from its rank records)"
                           if name == "fancy_nodes_copied" else "")
            + f": {r.get('rows', r.get('n'))} records ({r['bytes']} bytes) "
            f"equal to the plain version; build kernel {r['ms']:.4f} ms (1 "
            f"launch), plain {r['plain_ms']:.3f} ms; bound "
            f"{r['bound_ms']:.4f} ms ({r['pct_of_bound']:.1f}% of it)")
    log(f"nn kernel vs plain: nn_predict, an untrained model of "
        f"{nk['chunks']} chunks x {nk['units']} units (seed {SEED}): "
        f"{nk['lanes']} ranks equal (phase 5's {N_QUERIES} x, all "
        f"{nk['kmers']} genome k-mers, phase 5's x sorted and {N_QUERIES} x "
        f"in one chunk), 1 launch a call; kernel "
        f"{nk['ms']:.4f} ms on the card (kernel_device_ms), a wrapper call "
        f"{nk['call_ms']:.4f} ms (CUDA events), plain {nk['plain_ms']:.3f} "
        f"ms on {N_QUERIES} lanes; bound {nk['bound_ms']:.4f} ms by {nk['bound_by']} (fp64 "
        f"operations {nk['ops_ms']:.4f} ms, bytes {nk['bytes_ms']:.4f} ms; "
        f"{nk['pct_of_bound']:.1f}% of it); sorted x "
        f"{nk['batch_ms']['sorted x']:.4f} ms, one chunk "
        f"{nk['batch_ms']['one chunk']:.4f} ms")
    wf = nk["wavefronts"]
    log(f"nn kernel: modelled shared wavefronts of the parameter loads "
        f"(nn_shared_wavefronts, {wf['loads_a_lane']} loads a lane, "
        f"{wf['warps']} warps of phase 5's x, "
        f"{nk['distinct_chunks_a_warp']:.2f} distinct chunks a warp in the "
        f"caller's order): caller's order (one thread a lane) "
        f"{wf['caller_warp']['per_load']:.3f} a load / "
        f"{wf['caller_warp']['per_warp']:.1f} a warp whole-warp rule, "
        f"{wf['caller_half']['per_load']:.3f} / "
        f"{wf['caller_half']['per_warp']:.1f} half-warp rule; grouped "
        f"{wf['grouped_warp']['per_load']:.3f} / "
        f"{wf['grouped_warp']['per_warp']:.1f} and "
        f"{wf['grouped_half']['per_load']:.3f} / "
        f"{wf['grouped_half']['per_warp']:.1f}")

    # 4. aligner (and 4b), 5. query, 6. length sweep, 7. baselines,
    # 8. scale
    al = aligner_phase(dev, seq, idx16, workdir=td)
    if min(al["launches"].values()) == 0:
        raise AssertionError(f"SW kernel not launched: {al['launches']}")
    log(f"aligner: {N_READS} reads in {al['seconds']:.3f} s = "
        f"{al['reads_per_s']:.1f} reads/s; aligned {al['aligned']}, within "
        f"10 bp of truth {al['near']}; first {al['sam_checked']} reads' SAM "
        f"byte-identical to the CPU path; launches {al['launches']}, "
        f"query kernels {al['query_launches']}; phases "
        f"{json.dumps({k: round(v, 3) for k, v in al['phases'].items()})}")
    if al["aligned"] < 0.9 * N_READS or al["near"] < 0.8 * al["aligned"]:
        raise AssertionError(f"too few good alignments: {al}")
    log(f"aligner without prefix arrays: first {N_SAM_CHECK} reads in "
        f"{al['bare_seconds']:.3f} s; SAM byte-identical to phase 4's; "
        f"query kernels {al['bare_query_launches']}")
    qr = query_phase(dev, idx21)
    log(f"query: {N_QUERIES} 21-base queries in {qr['ms']:.3f} ms = "
        f"{qr['qps']:.1f} q/s; self-check {qr['self_check']}/"
        f"{qr['in_genome']} in-genome; first {N_QUERY_CHECK} positions "
        f"identical to the CPU path; query kernels {qr['launches']}")
    for row in sweep_phase(dev, idx21):
        log(f"sweep L={row['length']}: " + "; ".join(
            f"{name} ({r['form']}) {r['ms']:.3f} ms = {r['qps']:.1f} q/s, "
            f"{r['bisect_rounds']} bisection rounds, {r['stride_steps']} "
            f"stride steps, {r['launches']} launch" for name, r in row.items()
            if isinstance(r, dict))
            + f"; self-check {row['self_check']}/{row['in_genome']} "
            "in-genome, both indexes agree on every lane, first "
            f"{N_QUERY_CHECK} identical to the CPU path")
    bl = baseline_phase(dev, idx21, tables)
    log(f"baselines: {N_QUERIES} 21-base queries: binary search "
        f"{bl['binsearch']['ms']:.3f} ms = {bl['binsearch']['qps']:.1f} q/s, "
        f"llcp/rlcp-pruned {bl['fancy']['ms']:.3f} ms = "
        f"{bl['fancy']['qps']:.1f} q/s, plquery (phase 5) "
        f"{qr['qps']:.1f} q/s; in-genome self-checked, first "
        f"{N_QUERY_CHECK} identical to the CPU path; kernels: binary "
        f"search {bl['binsearch']['launches']}, pruned "
        f"{bl['fancy']['launches']}")
    sc = scale_phase(dev, scale[1], scale[2])
    for r in sc["rows"]:
        log(f"scale n={sc['n']} 2^{r['buckets']} ({r['table']} table) "
            f"L={r['length']}: {N_QUERIES} queries in {r['ms']:.3f} ms = "
            f"{r['qps']:.1f} q/s; self-check {r['self_check']}/"
            f"{r['in_genome']} in-genome, first {N_QUERY_CHECK} identical "
            f"to the CPU path; {r['launches']} plquery launch")
    log(f"scale: loaded memory-mapped without inv/lcpk, device arrays "
        f"sent in {sc['send_s']:.2f} s, with plquery's record tables "
        f"{sc['device_bytes'] / 1e9:.3f} GB (device_bytes), peak device "
        f"memory {sc['peak_bytes'] / 1e9:.3f} GB "
        "(torch.cuda.max_memory_allocated); swap_table kept rev, packed "
        "and the rank records in place and made the bucket records anew")

    # 9. the NN predictor
    t0 = time.perf_counter()
    nn = nn_phase(dev, idx21)
    t = idx21.table
    log(f"nn: train_serving {NN_CHUNKS} chunks x {NN_UNITS} units, "
        f"{NN_EPOCHS} epochs on the card: {nn['trained']}; trained and "
        f"audited in {nn['train_audit_s']:.2f} s (the audit alone "
        f"{nn['audit_s']:.2f} s); NN windows most=({nn['windows'][0]},"
        f"{nn['windows'][1]}) max=({nn['windows'][2]},{nn['windows'][3]}), "
        f"PWL most=({t.most_over},{t.most_under}) max=({t.max_over},"
        f"{t.max_under}); every audit error inside the max windows")
    log(f"nn: predicted ranks of all {nn['n_kmers']} k-mers equal on the "
        f"card and the CPU ({nn['ranks_s']:.2f} s)")
    log(f"nn: NNQueryEngine, {N_QUERIES} 21-base queries in "
        f"{nn['ms']:.3f} ms = {nn['qps']:.1f} q/s, {nn['nn_rounds']} "
        f"bisection rounds (PWL in turns: {nn['pwl_ms']:.3f} ms = "
        f"{nn['pwl_qps']:.1f} q/s, {nn['pwl_rounds']} rounds; NN/PWL = "
        f"{nn['ratio']:.3f}; median of 3 timings each); "
        f"self-check {nn['in_genome']}/{nn['in_genome']} in-genome, first "
        f"{N_QUERY_CHECK} identical to the CPU path; kernels "
        f"{nn['launches']}; predict_ranks alone (kernel) "
        f"{nn['predict_ms']:.4f} ms, the plain nn_predict in turns "
        f"{nn['predict_plain_ms']:.3f} ms")
    tp = nn["train_parity"]
    log(f"nn: training card vs CPU (8 kbp, k=11, 4 x 8, 200 epochs): stop "
        f"epochs {tp['stops']} on both, {tp['epochs']} epochs, loss "
        f"histories within {tp['max_rel']:.2e} relative (limit "
        f"{NN_TRAIN_RTOL:g}); card {tp['card_s']:.2f} s, CPU "
        f"{tp['cpu_s']:.2f} s; phase 9 took {time.perf_counter() - t0:.1f} s")

    # 10. sharded serving in spawned ranks
    _p10_log(multi_rank_phase(td, idx16, idx21, qr, sc, nn), qr, sc)

    # 11. profiling, evalx, the gather microbenchmark
    last_modules_phase(dev, seq, idx21, td, al)
    return kp, qk, fnodes, recs, nk, al, qr, bl, nn, sc


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch  # noqa: F401  (fails here on a machine without PyTorch)

    from sapling_tpu_torch.ops import nn_predict_cuda, query_cuda, sw_cuda

    # 1. the card
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    info = card()
    log(info["name_power"])
    log(f"card: max SM clock {info['sm_clock_max']} (the bound's clock); "
        f"{info['uuid']} on host {info['host']}")
    sm_clock_mhz = float(info["sm_clock_max"].split()[0])

    # 2. build (host work first: nothing has touched CUDA yet); the
    # scale build runs in a child while the 4.6 Mbp indexes and the SW
    # kernels build, and ends before anything is timed
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        scale = start_scale_build(td)
        try:
            kp, qk, fnodes, recs, nk, al, qr, bl, nn, sc = run_phases(
                td, scale, sm_clock_mhz)
        finally:
            if scale[0].poll() is None:
                os.killpg(scale[0].pid, signal.SIGKILL)
                scale[0].wait()

    src = os.path.relpath(sw_cuda.SOURCE, ROOT)
    kernels = [
        {"name": "sw_pass_full", "route": "cuda", "source": src,
         "replaces": "sapling_tpu/ops/sw_pallas.py:36",
         "launches": al["launches"]["full"], **kp["full"]},
        {"name": "sw_pass_score_only", "route": "cuda", "source": src,
         "replaces": "sapling_tpu/ops/sw_pallas.py:81",
         "launches": al["launches"]["score_only"], **kp["score_only"]},
    ]
    # the query kernels' rows: phase 3b's case on phase 5's queries (k=21
    # index as built: plquery, the binary search, the pruned search with
    # prefix64, its node records, plquery's record tables); launches of
    # phase 5's, 7's and 8's main calls (phase 5's first query on the card
    # makes the bucket records, phase 8's the 46 Mbp index's rank records
    # too). No PyTorch call computes any of them.
    qsrc = os.path.relpath(query_cuda.SOURCE, ROOT)
    for name, replaces, row, launches in (
            ("plquery", "sapling_tpu/ops/query.py:1011",
             next(r for r in qk if r["kernel"] == "plquery"
                  and r["name"].startswith(f"built L={QUERY_LEN} ")),
             qr["launches"]["plquery"]),
            ("binsearch", "sapling_tpu/ops/query.py:1370",
             next(r for r in qk if r["kernel"] == "binsearch"),
             bl["binsearch"]["launches"]["binsearch"]),
            ("fancy_binsearch", "sapling_tpu/ops/query.py:1404",
             next(r for r in qk if r["kernel"] == "fancy"),
             bl["fancy"]["launches"]["fancy"]),
            ("fancy_nodes", "sapling_tpu/ops/query.py:1404", fnodes,
             bl["fancy"]["launches"]["fancy_nodes"]),
            ("bucket_records", "sapling_tpu/ops/predict.py:231",
             recs["bucket_records"], qr["launches"]["bucket_records"]),
            ("plquery_records", "sapling_tpu/ops/query.py:1011",
             recs["plquery_records"], sc["launches"]["plquery_records"])):
        kernels.append({
            "name": name, "route": "cuda", "source": qsrc,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    # the NN rank prediction: phase 3b's untrained model on phase 5's x;
    # launches of phase 9's engine call. No PyTorch call computes it.
    kernels.append({
        "name": "nn_predict", "route": "cuda",
        "source": os.path.relpath(nn_predict_cuda.SOURCE, ROOT),
        "replaces": "sapling_tpu/models/serve.py:63",
        "launches": nn["launches"]["nn_predict"], "max_abs_err": 0,
        "ms": nk["ms"], "plain_ms": nk["plain_ms"],
        "bound_ms": nk["bound_ms"], "bound_by": nk["bound_by"],
        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
