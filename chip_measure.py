#!/usr/bin/env python3
"""Chip measurements of the PyTorch port on one GPU (the numbers in PERF.md).

    python3 chip_measure.py [out.json] [--against=path/to/other/sw.cu]
    python3 chip_measure.py [out.json] --against-query=path/to/query.cu ...
        [--query-variants=no_bucket_records,blocks6]
        [--query-kernels=plquery,binsearch,fancy,records]
        [--big=path/to/artifact.stpu.npz ...]
    python3 chip_measure.py [out.json] --against-nn=path/to/nn_predict.cu ...
        [--nn-variants=tile=1024,align=8]

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
           the kernel's rounds (stats=True), and one profiled call per
           index at lengths 21 and 101;
  baselines: the plain and the llcp/rlcp-pruned binary search on the
           21-base queries, three timings and one profiled call each.

With --against-query (one or more), --query-variants or --query-kernels,
it measures only this instead:

  query_ab: each other version of csrc/query.cu (the same C entry points,
           or those of a version from before plquery's record tables,
           the pruned search's node records or the 32-bit genome's record
           builders, each called as it was; built with the same flags;
           one that does not build is left out), and this tree's changed
           by each of --query-variants (QUERY_VARIANTS: the prediction
           read from xlist / ylist, 6 blocks an SM, the record builders'
           variants), timed in turns with this
           tree's (other, this, this, other, AB_ROUNDS times; CUDA events)
           on the same CUDA tensors, their positions held equal, in these
           cases of --query-kernels (default all), each in chip_smoke's
           order and shuffled (chip_smoke.shuffled): plquery on the 4.6
           Mbp k=21 index at PLQUERY_LENGTHS and the NN engine's call
           (nn_engine_case), chip_smoke phase 8's 46 Mbp artifact (no
           prefix arrays) and each --big artifact at L=21 and 101, the
           binary search at L=21 on each, and the llcp/rlcp-pruned search
           at L=21 with and without prefix64 and at L=101 without on the
           4.6 Mbp index and at L=21 and 101 on each artifact up to
           REAL_TABLES_N ranks (its tables from its LCP:
           chip_smoke.scale_tables); the record builders (records_ab:
           plquery's rank records and the node records on each index,
           past REAL_TABLES_N of seeded tables, with their bounds, the
           genome sectors a rank reads and the build's peak memory);
           plquery's probe sources (rank
           records, rev and the genome, fast3) in turns (probe_sources),
           the NN engine's call included; each
           case's bounds (chip_smoke.query_bound_ms over this build's
           sector trace, and query_rate_bound_ms at the random sector
           rate the run measures, chip_smoke.random_sector_rate) and lane
           utilisation (chip_smoke.lane_utilisation), an older plquery's
           own distinct sectors and bounds, and for the pruned search its
           node records' build time and bytes; each artifact's device
           bytes (arrays and record tables) and peak device memory; and
           of each build the registers, stack
           and spills of every kernel (nvcc's -Xptxas -v log) and the CALL
           instructions in its SASS by target (cuobjdump): the int64
           division subroutine's.

With --against-nn (one or more) or --nn-variants, it measures only this
instead:

  nn_ab:   each other version of csrc/nn_predict.cu (same C entry point),
           and this tree's with each change of --nn-variants (the tile a
           block groups, the padding, the search table: NN_VARIANTS),
           timed in turns with this tree's (other, this, this,
           other, AB_ROUNDS times; CUDA events around wrapper calls, and
           the kernel's own device time, chip_smoke.kernel_device_ms) on
           chip_smoke's untrained model at phase 9's width
           (chip_smoke.nn_untrained), on phase 5's 1M x, every genome
           k-mer, 5M k-mers drawn as bench_nn_query draws its queries,
           phase 5's x sorted and 1M x in one chunk (chip_smoke.
           nn_batches), their ranks held equal; the plain nn_predict's
           time; the bound (chip_smoke.nn_bound_ms); each build's
           registers and spills and the fp64-pipe instructions in its
           SASS (sass_fp64); and this tree's kernel built with a clock
           at each barrier (nn_phase_source): each phase's cycles a tile
           in the same cases (nn_phases).

Profiled calls also give the device's busy share within their own
window. Prints one line per measurement and writes all of them, with the
card's name, power limit and UUID and the host's name, as JSON to
out.json (default
chiprun_out/measure.json). Exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes
import json
import os
import signal
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
AB_ROUNDS = 8     # (other, this, this, other) rounds of a query_ab case


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


def build_report(lib_path: str) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads, calls}} of a
    query library: nvcc's -Xptxas -v log beside it (ops.sw_cuda.
    build_kernel keeps it) and the CALL instructions of each kernel's SASS
    by target address (cuobjdump names no target; query.cu calls only the
    int64 division subroutine, once for each of predict_pwl's two
    divisions, so `calls` counts those)."""
    import collections
    import re
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    def short(mangled):
        m = re.search(r"nn_predict_kernelILb([01])E(?:Li(\d+)E)?", mangled)
        if m:
            shared = "true" if m.group(1) == "1" else "false"
            width = "" if m.group(2) is None else f", {m.group(2)}"
            return f"nn_predict_kernel<{shared}{width}>"
        if "bucket_records_kernel" in mangled:
            return "bucket_records_kernel"
        m = re.search(r"records_kernelI([il])Li(\d)E", mangled)
        if m:
            rev = {"i": "int32", "l": "int64"}[m.group(1)]
            kind = ("rank records", "node records",
                    "nodes from rank records")[int(m.group(2))]
            return f"records_kernel<{rev}, {kind}>"
        m = re.search(r"(plquery_kernel|fancy_binsearch_kernel|"
                      r"fancy_nodes_kernel|binsearch_kernel|"
                      r"rank_records_kernel|records_kernel)"
                      r"I(?:Li(\d+)E)?([il])?(?:Lb([01])E)?E", mangled)
        if not m:
            return mangled
        args = [m.group(2), {"i": "int32", "l": "int64", None: None}[
            m.group(3)], {"0": "false", "1": "true", None: None}[m.group(4)]]
        return f"{m.group(1)}<{', '.join(a for a in args if a)}>"

    out = {}
    with open(lib_path[:-3] + ".log") as f:
        log_text = f.read()
    for m in re.finditer(
            r"Function properties for (\S+)\s+(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads\s+"
            r"ptxas info\s+: Used (\d+) registers", log_text):
        out[short(m.group(1))] = dict(
            stack=int(m.group(2)), spill_stores=int(m.group(3)),
            spill_loads=int(m.group(4)), registers=int(m.group(5)))
    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib_path],
        capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = short(func.split("\n", 1)[0].strip())
        calls = collections.Counter(
            t.strip() for t in re.findall(r"CALL\.\S*\s+([^;]*);", func))
        out.setdefault(name, {})["calls"] = dict(calls)
        if name.startswith("nn_predict_kernel"):
            out[name]["fp64"] = sass_fp64(func)
    return out


def sass_fp64(func: str) -> dict:
    """The fp64-pipe instructions of one function's SASS (DADD, DMUL, DFMA,
    DSETP, DMNMX, the F64 conversions and roundings, MUFU.RCP64H), by
    opcode, in its body and in the subroutines it calls (from the lowest
    CALL target on: the division's slow path)."""
    import collections
    import re

    ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", t.strip()).split()[0])
           for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
    targets = [int(t, 16) for t in
               re.findall(r"CALL\.\S*\s+(0x[0-9a-f]+)", func)]
    sub = min(targets, default=float("inf"))

    def fp64(op):
        return (op.split(".")[0] in ("DADD", "DMUL", "DFMA", "DSETP",
                                     "DMNMX") or "F64" in op
                or "RCP64H" in op)

    body = collections.Counter(op for at, op in ins if at < sub and fp64(op))
    subs = collections.Counter(op for at, op in ins if at >= sub and fp64(op))
    return dict(body=dict(body.most_common()), body_total=sum(body.values()),
                subroutines=dict(subs.most_common()),
                subroutines_total=sum(subs.values()))


# fancy_binsearch_launch of a query.cu from before the node records (the
# first design of the pruned search: it reads llcp / rlcp, rev and prefix64
# or the genome itself)
TABLES_FANCY = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_int] + [ctypes.c_void_p] * 8 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]
# fancy_binsearch_launch of a query.cu from the node records to the 32-bit
# genome's builders: TABLES_FANCY's arguments and the node records
NODES_FANCY = TABLES_FANCY[:12] + [ctypes.c_void_p] + TABLES_FANCY[12:]
# the record builders' entry points of such a query.cu (the int64 words)
OLD_BUILDERS = {
    "rank_records_launch": [ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_void_p],
    "fancy_nodes_launch": [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p]}
# plquery_launch of a query.cu from before plquery's record tables (it
# reads xlist, ylist, bounds, rev, prefix64 and the genome)
ARRAYS_PLQUERY = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                  ctypes.c_int] + [ctypes.c_void_p] * 13 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int] + [ctypes.c_longlong] * 5 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def bind_query(path: str):
    """A query library with its C entry points typed: this tree's, or an
    older one's. One from before plquery's record tables (no
    bucket_records_launch) takes ARRAYS_PLQUERY's arguments
    (with_query_lib calls it through plquery_arrays); one from before this
    tree's record builders (no records_launch) has their int64-word entry
    points (OLD_BUILDERS, if any: record_call) and takes for its pruned
    search NODES_FANCY's arguments, or from before the node records (no
    fancy_nodes_launch) TABLES_FANCY's (fancy_older); the first version
    has no pruned search."""
    from sapling_tpu_torch.ops import query_cuda, sw_cuda

    has = ctypes.CDLL(path)
    sig = {k: v for k, v in {**query_cuda.SIGNATURES, **OLD_BUILDERS}.items()
           if hasattr(has, k)}
    arrays = not hasattr(has, "bucket_records_launch")
    older = not hasattr(has, "records_launch")
    tables = not hasattr(has, "fancy_nodes_launch")
    if arrays:
        sig["plquery_launch"] = ARRAYS_PLQUERY
    if older and "fancy_binsearch_launch" in sig:
        sig["fancy_binsearch_launch"] = TABLES_FANCY if tables else NODES_FANCY
    lib = sw_cuda.bind_lib(path, sig)
    lib.arrays_plquery, lib.older_fancy, lib.tables_fancy = (arrays, older,
                                                             tables)
    return lib


# the probes of a query.cu from before plquery's record tables
ARRAYS_PROBES = {"fast3": 0, "prefix64": 1, "packed": 2}


def plquery_arrays(lib, fast3_q3=None):
    """query_cuda.plquery_cuda for a library from before plquery's record
    tables: the same call (stats and trace included) on the probe that
    design took for the index's arrays (ops.query_cuda.probe_form: fast3
    where prefix3 and q3 are given; `fast3_q3`, that design's q3, where
    the call passes none), without the records."""
    import torch

    from sapling_tpu_torch.ops import query_cuda
    from sapling_tpu_torch.ops.query_cuda import _ptr

    def call(packed, rev, xlist, ylist, q_words, x, prefix=None,
             prefix3=None, q3=None, bounds=None, *, n, length, k, buckets,
             most_over, most_under, max_over, max_under,
             max_stride_steps=1 << 20, adaptive_bounds=False, pred64=None,
             bucket_recs=None, rank_recs=None, stats=False, trace=0):
        if q3 is None:
            q3 = fast3_q3
        form = query_cuda.probe_form(length, k, prefix, prefix3, q3)
        dev, b = x.device, x.shape[0]
        out = torch.empty(b, dtype=torch.int64, device=dev)
        lane, depth, tr = query_cuda.stats_buffers(b, dev, stats, trace)
        rc = lib.plquery_launch(
            packed.data_ptr(), packed.shape[0], rev.data_ptr(),
            int(rev.dtype == torch.int64), xlist.data_ptr(),
            ylist.data_ptr(), _ptr(prefix), _ptr(prefix3),
            _ptr(bounds) if adaptive_bounds else None, _ptr(q_words),
            _ptr(q3), x.data_ptr(), _ptr(pred64), out.data_ptr(), _ptr(lane),
            _ptr(depth), _ptr(tr), b, n, length, k, buckets, most_over,
            most_under, max_over, max_under, max_stride_steps,
            int(adaptive_bounds), 0 if tr is None else tr.shape[1],
            ARRAYS_PROBES[form], torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"plquery kernel launch failed: cudaError {rc}")
        if stats:
            query_cuda._read_stats(lane, depth, tr)
        return out

    return call


def fancy_older(lib):
    """query_cuda.fancy_binsearch_cuda for a library from before this
    tree's pruned-search entry point (it also takes rev, llcp, rlcp and
    prefix, and from the node records on the records): the same call,
    without stats (older libraries are timed, not traced)."""
    import torch

    from sapling_tpu_torch.ops.query_cuda import PROBES, _ptr

    def call(packed, rev, llcp, rlcp, q_words, *, n, length, prefix=None,
             nodes=None, stats=False, trace=0):
        if stats or trace:
            raise ValueError("an older pruned search runs without stats")
        dev, b = q_words.device, q_words.shape[1]
        form = "prefix64" if prefix is not None and length <= 32 else "packed"
        out = torch.empty(b, dtype=torch.int64, device=dev)
        rc = lib.fancy_binsearch_launch(
            packed.data_ptr(), packed.shape[0], rev.data_ptr(),
            int(rev.dtype == torch.int64), llcp.data_ptr(), rlcp.data_ptr(),
            _ptr(prefix) if form == "prefix64" else None,
            *(() if lib.tables_fancy else (nodes.data_ptr(),)),
            q_words.data_ptr(), out.data_ptr(), None, None, None, b, n,
            length, 0, PROBES[form if lib.tables_fancy else
                              "prefix64" if length <= 32 else "packed"],
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fancy kernel launch failed: cudaError {rc}")
        return out

    return call


# this tree's csrc/query.cu changed: {name: (pattern, replacement) or a
# list of them}
# (query_variant): the prediction reading xlist, ylist and bounds as the
# first design read them, not its bucket record; plquery_kernel held to 6
# blocks of 256 an SM (40 registers a thread)
QUERY_VARIANTS = {
    "no_bucket_records": (
        r"  const longlong2\* rec = a\.bucket_recs.*?\n  \}\n",
        """  const int64_t xlo = __ldg(a.xlist + bucket);
  const int64_t xhi = __ldg(a.xlist + bucket + 1);
  const int64_t ylo = __ldg(a.ylist + bucket);
  const int64_t m = __ldg(a.ylist + bucket + 1) - ylo;
  lane.touch(a.xlist + bucket, a.xlist + bucket + 1);
  lane.touch(a.ylist + bucket, a.ylist + bucket + 1);
  if (a.adaptive) {
    lane.touch(a.bounds + bucket);
    *bw = (uint32_t)__ldg(a.bounds + bucket);
  }
"""),
    "blocks6": (r"__launch_bounds__\(kThreads\) plquery_kernel",
                "__launch_bounds__(kThreads, 6) plquery_kernel"),
    # the record builders: node records stored from registers (two 16-byte
    # stores a lane, half of each sector a store); the streams through the
    # default cache policy; the int64 words (the caller passes them,
    # record_call); the 32-bit genome as a persisting L2 access-policy
    # window for the launch
    "no_stage": (
        r"    // the warp's 32 records into its stage.*?stage\[c\]\);\n",
        """    if (r < a.n) {
      stream_store(out + 2 * r, rec);
      stream_store(out + 2 * r + 1, make_longlong2((long long)lcps, 0));
    }
"""),
    "cached": [(r"  return __ldcs\(p\);", "  return __ldg(p);"),
               (r"  __stcs\(p, v\);", "  *p = v;")],
    "genome64": (r"__ldg\(a\.genome32 \+ ",
                 "__ldg(reinterpret_cast<const int64_t*>(a.genome32) + "),
    "l2_window": (
        r"  records_kernel<REV, KIND><<<.*?"
        r"  return \(int\)cudaGetLastError\(\);\n",
        """  int dev = 0, max_window = 0, max_persist = 0;
  size_t limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize,
                         dev);
  cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize,
                         dev);
  cudaDeviceGetLimit(&limit, cudaLimitPersistingL2CacheSize);
  const size_t bytes = (size_t)a.packed_len * 4;
  const size_t window = bytes < (size_t)max_window ? bytes : max_window;
  const size_t persist = window < (size_t)max_persist ? window : max_persist;
  cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, persist);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeAccessPolicyWindow;
  attr[0].val.accessPolicyWindow.base_ptr = (void*)a.genome32;
  attr[0].val.accessPolicyWindow.num_bytes = window;
  attr[0].val.accessPolicyWindow.hitRatio = (float)persist / (float)window;
  attr[0].val.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
  attr[0].val.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, records_kernel<REV, KIND>, a, out);
  if (e == cudaSuccess) e = cudaStreamSynchronize(stream);
  cudaCtxResetPersistingL2Cache();
  cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, limit);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
"""),
}


def query_variant(name: str) -> str:
    """This tree's csrc/query.cu changed by QUERY_VARIANTS[name], written
    beside the builds (ops.sw_cuda.BUILD_DIR); returns its path."""
    import re

    from sapling_tpu_torch.ops import query_cuda, sw_cuda

    changes = QUERY_VARIANTS[name]
    with open(query_cuda.SOURCE) as f:
        src = f.read()
    for pattern, repl in (changes if isinstance(changes, list)
                          else [changes]):
        src, n = re.subn(pattern, lambda _m, r=repl: r, src, flags=re.S)
        assert n == 1, f"{name}: {n} matches of {pattern!r} in csrc/query.cu"
    os.makedirs(sw_cuda.BUILD_DIR, exist_ok=True)
    path = os.path.join(sw_cuda.BUILD_DIR, f"query_{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def with_query_lib(lib, fn, fast3_q3=None):
    """fn() with query_cuda's launches going to the library `lib` (an older
    one's plquery through plquery_arrays, with fast3_q3, its pruned search
    through fancy_older)."""
    from sapling_tpu_torch.ops import query_cuda

    saved = (query_cuda._LIB, query_cuda.fancy_binsearch_cuda,
             query_cuda.plquery_cuda)
    query_cuda._LIB = lib
    if getattr(lib, "older_fancy", False):
        query_cuda.fancy_binsearch_cuda = fancy_older(lib)
    if getattr(lib, "arrays_plquery", False):
        query_cuda.plquery_cuda = plquery_arrays(lib, fast3_q3)
    try:
        return fn()
    finally:
        (query_cuda._LIB, query_cuda.fancy_binsearch_cuda,
         query_cuda.plquery_cuda) = saved


# plquery's query lengths on the 4.6 Mbp index (the aligner's seeds are 16
# bases); on the artifacts chip_smoke.SCALE_LENGTHS
PLQUERY_LENGTHS = (16, 21, 101)
QUERY_KERNELS = ("plquery", "binsearch", "fancy", "records")


def nn_engine_case(didx, codes):
    """The NN engine's call of chip_smoke phase 9 on `didx` (on the card):
    the model trained as there (train_serving), then plquery_cuda with its
    predict_ranks as pred64, its windows, the fast3 probe's q3 where the
    index has prefix3 (NNQueryEngine.query_inputs) and the index's rank
    records, as NNQueryEngine.query_device makes the call; a query_cases
    dict (with the trained model, `srv`)."""
    from sapling_tpu_torch.models.serve import train_serving
    from sapling_tpu_torch.ops import query_cuda

    srv = train_serving(didx, num_chunks=cs.NN_CHUNKS,
                        layer_size=cs.NN_UNITS, epochs=cs.NN_EPOCHS, seed=0,
                        log=lambda _msg: None)
    args, kw, _form, lane_bytes, recs = cs.plquery_inputs(
        didx, codes.shape[1], codes, fast3=True, most_over=srv.most_over,
        most_under=srv.most_under, max_over=srv.max_over,
        max_under=srv.max_under)
    x = args[5]
    return dict(name=f"{didx.n} bp nn engine L={codes.shape[1]}",
                call=lambda **st: query_cuda.plquery_cuda(
                    *args, pred64=srv.predict_ranks(x),
                    rank_recs=recs["rank_recs"], **st, **kw),
                lanes=len(codes), lane_bytes=lane_bytes + 8,
                kernel="plquery", srv=srv)


def query_cases(dev, idx21, bigs, tables, big_tables, kernels):
    """The query_ab cases of `kernels` (QUERY_KERNELS), each in
    chip_smoke's order and shuffled: dicts of name, call(**stats) ->
    positions, lanes, coalesced bytes a lane and, for the pruned search,
    the build of its node records (made once for an index and its tables,
    outside the timed calls). plquery: the 4.6 Mbp index as built at
    PLQUERY_LENGTHS (an older query.cu reads its prefix arrays: fast3 up to
    21 bases), the NN engine's call (nn_engine_case, in chip_smoke's
    order), and every artifact of `bigs` at chip_smoke.SCALE_LENGTHS, on
    each index's record tables (query_records)."""
    import torch

    from sapling_tpu_torch.ops import query_cuda

    def plquery(tag, idx, length, codes):
        args, kw, form, lane_bytes, recs = cs.plquery_inputs(idx, length,
                                                             codes)
        return dict(name=f"{tag} L={length} {form}", call=lambda **st:
                    query_cuda.plquery_cuda(*args, **recs, **st, **kw),
                    lanes=len(codes), lane_bytes=lane_bytes,
                    kernel="plquery", fast3_q3=cs.plquery_inputs(
                        idx, length, codes, fast3=True)[0][8])

    def binsearch(tag, didx, codes):
        qw, kw, lane_bytes = cs.binsearch_inputs(didx, codes)
        d = didx.device_arrays()
        return dict(name=f"{tag} binary search L={codes.shape[1]}",
                    call=lambda **st: query_cuda.binsearch_cuda(
                        d["packed"], d["rev"], qw, **st, **kw),
                    lanes=len(codes), lane_bytes=lane_bytes)

    def fancy(tag, didx, lr, codes):
        qw, kw, lane_bytes = cs.binsearch_inputs(didx, codes)
        d = didx.device_arrays()
        nodes = didx.fancy_nodes(*lr)
        length = codes.shape[1]
        form = ("prefix64" if d["prefix64"] is not None and length <= 32
                else "packed")
        return dict(name=f"{tag} pruned binary search L={length} {form}",
                    call=lambda **st: query_cuda.fancy_binsearch_cuda(
                        d["packed"], d["rev"], *lr, qw, prefix=d["prefix64"],
                        nodes=nodes, **st, **kw),
                    lanes=len(codes), lane_bytes=lane_bytes,
                    build=lambda: query_cuda.fancy_nodes_cuda(
                        d["packed"], d["rev"], *lr, n=didx.n),
                    build_bytes=32 * didx.n)

    if "fancy" in kernels:
        lr = [torch.from_numpy(a).to(dev) for a in tables]
        big_lrs = [None if t is None else
                   [torch.from_numpy(a).to(dev) for a in t]
                   for t in big_tables]
    didx, bare = idx21.to(dev), cs.without_prefix(idx21).to(dev)
    cases = []
    for order in ("smoke", "shuffled"):
        def codes_of(idx, length):
            codes, _n_in = cs.query_codes(idx.codes, length)
            return cs.shuffled(codes) if order == "shuffled" else codes

        tag = f"{idx21.n} bp {order}"
        if "plquery" in kernels:
            cases += [plquery(tag, didx, length, codes_of(idx21, length))
                      for length in PLQUERY_LENGTHS]
            if order == "smoke":
                cases.append(nn_engine_case(didx, codes_of(idx21,
                                                           cs.QUERY_LEN)))
        if "binsearch" in kernels:
            cases.append(binsearch(tag, didx, codes_of(idx21, cs.QUERY_LEN)))
        if "fancy" in kernels:
            cases += [fancy(tag, didx, lr, codes_of(idx21, cs.QUERY_LEN)),
                      fancy(tag + " no_prefix", bare, lr,
                            codes_of(idx21, cs.QUERY_LEN)),
                      fancy(tag + " no_prefix", bare, lr,
                            codes_of(idx21, 101))]
        for i, big in enumerate(bigs):
            big_tag = f"{big.n} bp {order}"
            if "plquery" in kernels:
                cases += [plquery(big_tag, big, length, codes_of(big, length))
                          for length in cs.SCALE_LENGTHS]
            if "binsearch" in kernels:
                cases.append(binsearch(big_tag, big,
                                       codes_of(big, cs.QUERY_LEN)))
            if "fancy" in kernels and big_lrs[i] is not None:
                cases += [fancy(big_tag, big, big_lrs[i],
                                codes_of(big, length))
                          for length in cs.SCALE_LENGTHS]
    return cases


def in_turns(a, b, dev, rounds: int = AB_ROUNDS) -> tuple[list, list]:
    """CUDA-event ms of a() and b() in turns (a, b, b, a), `rounds` times:
    (a's times, b's times)."""
    t_a, t_b = [], []
    for _ in range(rounds):
        t_a.append(cs._time_ms(a, dev))
        t_b += [cs._time_ms(b, dev), cs._time_ms(b, dev)]
        t_a.append(cs._time_ms(a, dev))
    return t_a, t_b


def trace_bound(call, b: int, lane_bytes: int, sectors_per_s: float):
    """A case's distinct sectors (call's sector trace), both bounds
    (chip_smoke.query_bound_ms, query_rate_bound_ms), the lane utilisation,
    probes and sectors touched: a dict."""
    import torch

    from sapling_tpu_torch.ops import query_cuda

    call(stats=True, trace=cs.QK_TRACE)
    st = query_cuda.LAST_STATS
    tr = st["trace"]
    distinct = int(torch.unique(tr[tr >= 0]).numel())
    probes = st["probes"].cpu()
    row = dict(distinct=distinct,
               bound_ms=cs.query_bound_ms(distinct, b, lane_bytes),
               rate_bound_ms=cs.query_rate_bound_ms(distinct, b, lane_bytes,
                                                    sectors_per_s),
               util=cs.lane_utilisation(probes), probes=int(probes.sum()),
               sectors=int(st["sectors"].sum()))
    del tr, st
    query_cuda.LAST_STATS.clear()
    return row


def in_turns_against(name, first, sources, dev, sectors_per_s) -> dict:
    """Each of `sources` ({source: (call, lane bytes)}) in turns
    (in_turns) with the one named `first`, their positions held equal,
    each one's bounds from its own trace (trace_bound); logged, returned
    as {source: dict(ms, median, bound...)}."""
    import statistics

    import torch

    want = sources[first][0]()
    row = {}
    for src, (call, lane_bytes) in sources.items():
        if not torch.equal(call(), want):
            raise AssertionError(f"{src} != {first}: {name}")
        row[src] = trace_bound(call, len(want), lane_bytes, sectors_per_s)
    text = []
    for src, (call, _lb) in sources.items():
        if src == first:
            continue
        t_o, t_f = in_turns(call, sources[first][0], dev)
        med_o, med_f = statistics.median(t_o), statistics.median(t_f)
        row[src].update(ms=t_o, median=med_o, first_ms=t_f,
                        first_median=med_f)
        text.append(f"{src} {med_o:.4f} ms ({min(t_o):.4f}-{max(t_o):.4f}"
                    f"; {row[src]['distinct']} distinct sectors, bound "
                    f"{row[src]['bound_ms']:.4f} / at the measured rate "
                    f"{row[src]['rate_bound_ms']:.4f}) in turns with {first}"
                    f" {med_f:.4f} ms ({min(t_f):.4f}-{max(t_f):.4f}; "
                    f"{row[first]['distinct']} distinct sectors, bound "
                    f"{row[first]['bound_ms']:.4f} / "
                    f"{row[first]['rate_bound_ms']:.4f}): {med_o / med_f:.3f}"
                    f"x")
    log(f"probe sources {name}: " + "; ".join(text))
    return dict(name=name, **row)


def probe_sources(dev, idx21, bigs, nn_case, sectors_per_s) -> list[dict]:
    """plquery's probe sources on the same queries, bucket records and
    kernel, in turns (in_turns_against): rank records (one 16-byte load a
    probe) against rev and the genome (two dependent loads: what the
    kernel reads where query_cuda.reads_rank_records says no) and, where
    the index has prefix3 and the length allows, fast3 (one prefix3 load;
    the probe the caller asks for with q3), on the 4.6 Mbp index at
    PLQUERY_LENGTHS and each artifact of `bigs` at
    chip_smoke.SCALE_LENGTHS, in chip_smoke's order and shuffled; and the
    NN engine's call (nn_case: fast3) against the other two."""
    from sapling_tpu_torch.ops import query_cuda

    saved = query_cuda.reads_rank_records

    def on_arrays(call):
        def run(**st):
            query_cuda.reads_rank_records = lambda rev, packed: False
            try:
                return call(**st)
            finally:
                query_cuda.reads_rank_records = saved
        return run

    rows = []
    for order in ("smoke", "shuffled"):
        for idx, lengths in ((idx21.to(dev), PLQUERY_LENGTHS),
                             *((big, cs.SCALE_LENGTHS) for big in bigs)):
            for length in lengths:
                codes, _n_in = cs.query_codes(idx.codes, length)
                if order == "shuffled":
                    codes = cs.shuffled(codes)
                args, kw, _f, lane_bytes, recs = cs.plquery_inputs(
                    idx, length, codes, ranks=True)
                f3, _kw3, form3, lane3, _r3 = cs.plquery_inputs(
                    idx, length, codes, fast3=True)
                sources = {
                    "records": (lambda a=args, r=recs, k=kw, **st:
                                query_cuda.plquery_cuda(*a, **r, **st, **k),
                                lane_bytes),
                    "arrays": (on_arrays(
                        lambda a=args, r=recs, k=kw, **st:
                        query_cuda.plquery_cuda(
                            *a, bucket_recs=r["bucket_recs"], **st, **k)),
                        lane_bytes)}
                if form3 == "fast3":
                    sources["fast3"] = (
                        lambda a=f3, r=recs, k=kw, **st:
                        query_cuda.plquery_cuda(
                            *a, bucket_recs=r["bucket_recs"], **st, **k),
                        lane3)
                rows.append(in_turns_against(
                    f"{idx.n} bp {order} L={length}", "records", sources,
                    dev, sectors_per_s))
    if nn_case is not None:
        call = nn_case["call"]
        d = idx21.to(dev).device_arrays()
        ranks = query_cuda.plquery_records_cuda(d["packed"], d["rev"],
                                                n=idx21.n)

        def without_q3(**extra):
            real = query_cuda.plquery_cuda

            def patched(*a, **k):
                a = a[:8] + (None,) + a[9:]
                return real(*a, **dict(k, **extra))

            def run(**st):
                query_cuda.plquery_cuda = patched
                try:
                    return call(**st)
                finally:
                    query_cuda.plquery_cuda = real
            return run

        lb = nn_case["lane_bytes"]
        rows.append(in_turns_against(nn_case["name"], "fast3", {
            "fast3": (call, lb),
            "arrays": (on_arrays(without_q3()), lb + 8),
            "records": (without_q3(rank_recs=ranks), lb + 8)},
            dev, sectors_per_s))
    return rows


# the variants of QUERY_VARIANTS that change only the record builders
RECORD_VARIANTS = ("no_stage", "cached", "genome64", "l2_window")
# those that change only the genome's gathers
GATHER_VARIANTS = ("genome64", "l2_window")
# the builders' record kinds (the first two as query_cuda.LAUNCHES names
# them): node records as SaplingIndex.fancy_nodes makes them (from the
# index's rank records where it holds them), and gathered from the genome
# where it holds rank records too
RECORD_KINDS = ("plquery_records", "fancy_nodes", "fancy_nodes_gathered")
# up to this many ranks an artifact's node records are made of its own
# llcp / rlcp tables (scale_tables); past it of seeded random int32 tables
# of the same size: the builders copy the two words, their values move no
# byte, and the 230 Mbp tables' sparse table takes ~26 GB of the host
REAL_TABLES_N = 50_000_000
REAL_TABLES = "its llcp / rlcp"


def record_tables(big):
    """The llcp / rlcp tables the node records of artifact `big` are made
    of on the host: scale_tables up to REAL_TABLES_N ranks, else seeded
    random int32 in [0, 100] (a note says which)."""
    import numpy as np

    if big.n <= REAL_TABLES_N:
        return cs.scale_tables(big), REAL_TABLES
    rng = np.random.default_rng(cs.SEED)
    return tuple(rng.integers(0, 101, big.n, dtype=np.int32)
                 for _ in range(2)), "seeded random llcp / rlcp"


def record_call(lib, kind, didx, lr, variant=None):
    """One build of `kind` (RECORD_KINDS) on `didx` (on the card) through
    query library `lib`, as a function -> the records: a library with the
    32-bit genome's entry point (records_launch) through this tree's
    wrappers, as SaplingIndex calls them (the int64 words narrowed on the
    card first; "fancy_nodes" from the index's rank records where it
    holds them); an older one (rank_records_launch / fancy_nodes_launch,
    the int64 words, always gathering) through its own entry points. The
    variant "genome64" (the int64 words) calls records_launch with them."""
    import torch

    from sapling_tpu_torch.ops import query_cuda

    d = didx.device_arrays()
    n, dev = didx.n, d["rev"].device
    rev64 = int(d["rev"].dtype == torch.int64)
    nodes = kind != "plquery_records"
    tabs = lr if nodes else (None, None)
    ranks = didx.query_records()[1] if kind == "fancy_nodes" else None

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def out():
        return torch.empty((n, 4 if nodes else 2), dtype=torch.int64,
                           device=dev)

    def checked(rc):
        if rc:
            raise RuntimeError(f"{kind} launch failed: cudaError {rc}")

    if not hasattr(lib, "records_launch"):
        def old():
            recs = out()
            checked(lib.fancy_nodes_launch(
                d["packed"].data_ptr(), d["packed"].shape[0],
                d["rev"].data_ptr(), rev64, lr[0].data_ptr(),
                lr[1].data_ptr(), recs.data_ptr(), n, stream()) if nodes
                else lib.rank_records_launch(
                    d["packed"].data_ptr(), d["packed"].shape[0],
                    d["rev"].data_ptr(), rev64, recs.data_ptr(), n,
                    stream()))
            return recs
        return old
    if variant == "genome64":
        def direct():
            recs = out()
            checked(query_cuda.launch_records(lib, stream(), d["packed"],
                                              d["rev"], *tabs, recs, n=n))
            return recs
        return direct
    if nodes:
        return lambda: with_query_lib(lib, lambda: query_cuda.fancy_nodes_cuda(
            d["packed"], d["rev"], *lr, n=n, rank_recs=ranks))
    return lambda: with_query_lib(lib, lambda: query_cuda.plquery_records_cuda(
        d["packed"], d["rev"], n=n))


def key_sectors(didx) -> dict:
    """The 32-byte sectors of the genome that a rank's key reads (three
    words from rev[r] >> 4, clamped to the array), on average over the
    ranks of `didx` (on the card): as int64 words (the plain version's and
    the first builders') and as 32-bit words; with the genome's bytes in
    each form and the card's L2 size."""
    import torch

    d = didx.device_arrays()
    words = d["packed"].shape[0]
    out = dict(l2_bytes=torch.cuda.get_device_properties(
        d["rev"].device).L2_cache_size)
    for name, width in (("int64", 8), ("int32", 4)):
        total, step = 0, 1 << 26
        for i in range(0, didx.n, step):
            pos = d["rev"][i:i + step].long()
            if d["rev"].dtype == torch.int32:
                pos &= 0xFFFFFFFF
            w0 = torch.clamp(pos >> 4, max=words - 1)
            w2 = torch.clamp((pos >> 4) + 2, max=words - 1)
            total += int(((w2 * width + width - 1 >> 5)
                          - (w0 * width >> 5) + 1).sum())
        out[name] = dict(sectors_a_rank=total / didx.n,
                         genome_bytes=words * width)
    return out


def genome32_ms(didx, dev) -> dict:
    """The two ways to the builders' 32-bit genome on `didx` (on the
    card): the int64 device words narrowed as query_cuda.genome32 narrows
    them (CUDA events) and
    a send of the host's uint32 words as int32 (host clock around the copy
    and a sync; median of AB_ROUNDS)."""
    import statistics

    import numpy as np
    import torch

    words = didx.device_arrays()["packed"]
    host = np.ascontiguousarray(didx.packed).view(np.int32)
    sent = []
    for _ in range(AB_ROUNDS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        torch.from_numpy(host).to(dev)
        torch.cuda.synchronize(dev)
        sent.append((time.perf_counter() - t0) * 1e3)
    return dict(narrowed=cs._time_ms(lambda: words.to(torch.int32), dev),
                sent=statistics.median(sent))


def records_ab(dev, indexes, libs, names, variants) -> list[dict]:
    """The record builders (RECORD_KINDS) of every library in `libs`
    (their sources `names`; the first is this tree's, those of `variants`
    last) on each (index, llcp / rlcp tables on the card, tables note) of
    `indexes`: each other library's build in turns with the first's
    (in_turns), their records held equal word for word; the first's build
    alone timed too (median of AB_ROUNDS), its bound
    (chip_smoke.query_records_bound_ms / fancy_nodes_bound_ms: rev, the
    tables and the genome's int64 words read once, the records written
    once), the peak device memory a build adds, the records' bytes, and
    the genome sectors a rank's key reads (key_sectors). Where the index
    holds rank records, its node records copied from them are timed in
    turns with this tree's gathered ones too, and GATHER_VARIANTS run only
    on the gathered kind."""
    import statistics

    import torch

    rows = []
    tags = dict(zip(names[len(names) - len(variants):], variants))
    for didx, lr, note in indexes:
        sectors = key_sectors(didx)
        log(f"records {didx.n} bp: a rank's key reads "
            f"{sectors['int64']['sectors_a_rank']:.4f} sectors of the int64"
            f" genome ({sectors['int64']['genome_bytes'] / 1e6:.1f} MB), "
            f"{sectors['int32']['sectors_a_rank']:.4f} of the 32-bit one "
            f"({sectors['int32']['genome_bytes'] / 1e6:.1f} MB); L2 "
            f"{sectors['l2_bytes'] / 1e6:.1f} MB")
        sectors["genome32_ms"] = genome32_ms(didx, dev)
        log(f"records {didx.n} bp: the 32-bit genome narrowed on the card "
            f"{sectors['genome32_ms']['narrowed']:.4f} ms (CUDA events), "
            f"sent from the host's uint32 words "
            f"{sectors['genome32_ms']['sent']:.4f} ms (host clock, synced; "
            f"median of {AB_ROUNDS})")
        copies = didx.query_records()[1] is not None
        for kind in RECORD_KINDS:
            if kind == "fancy_nodes_gathered" and not copies:
                continue
            bound = (cs.query_records_bound_ms(didx)[kind]
                     if kind == "plquery_records"
                     else cs.fancy_nodes_bound_ms(didx))
            first = record_call(libs[0], kind, didx, lr)
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            want = first()
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - before
            nbytes = want.numel() * want.element_size()
            alone = [cs._time_ms(first, dev) for _ in range(AB_ROUNDS)]
            copied = kind == "fancy_nodes" and copies
            row = dict(n=didx.n, kind=kind, tables=note, bound_ms=bound,
                       bytes=nbytes, peak_bytes=peak, sectors=sectors,
                       ms=alone, median=statistics.median(alone),
                       copied=copied, against={})
            log(f"records {didx.n} bp {kind} ({note}"
                + (", copied from its rank records" if copied else "")
                + f"): {names[0]} "
                f"{row['median']:.4f} ms alone (median of {AB_ROUNDS}, "
                f"{min(alone):.4f}-{max(alone):.4f}); bound {bound:.4f} ms "
                f"({100 * bound / row['median']:.1f}% of it); records "
                f"{nbytes / 1e9:.3f} GB, the build's peak over them "
                f"{(peak - nbytes) / 1e6:.1f} MB")
            against = [(record_call(lib, kind, didx, lr, tags.get(src)), src)
                       for lib, src in zip(libs[1:], names[1:])
                       if not (kind == "fancy_nodes" and copies
                               and tags.get(src) in GATHER_VARIANTS)]
            if kind == "fancy_nodes" and copies:
                against.append((record_call(libs[0], "fancy_nodes_gathered",
                                            didx, lr),
                                f"{names[0]} gathered"))
            for other, src in against:
                if not torch.equal(other(), want):
                    raise AssertionError(f"{src} {kind} records differ from "
                                         f"{names[0]}'s: {didx.n} bp")
                t_o, t_f = in_turns(other, first, dev)
                med_o, med_f = statistics.median(t_o), statistics.median(t_f)
                row["against"][src] = dict(ms=t_o, this_ms=t_f, median=med_o,
                                           this_median=med_f)
                log(f"records {didx.n} bp {kind}: {src} {med_o:.4f} ms "
                    f"({min(t_o):.4f}-{max(t_o):.4f}; "
                    f"{100 * bound / med_o:.1f}% of the bound) in turns "
                    f"with {names[0]} {med_f:.4f} ms "
                    f"({min(t_f):.4f}-{max(t_f):.4f}; "
                    f"{100 * bound / med_f:.1f}%): {med_o / med_f:.3f}x")
            del want
            rows.append(row)
    return rows


def query_ab(dev, idx21, arts: list[str], others: list[str], tables,
             variants=(), kernels=QUERY_KERNELS) -> dict:
    """Each of `others` (query.cu versions) and this tree's source changed
    by each of `variants` (query_variant) in turns with this tree's on
    query_cases (of `kernels`) over the 4.6 Mbp index and the artifacts
    `arts`; with plquery, probe_sources; the random sector rate the
    second bound reads (chip_smoke.random_sector_rate); each artifact's
    device bytes (its arrays and record tables) and the peak device
    memory after its first queries; their builds' reports
    (build_report)."""
    import statistics
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from sapling_tpu_torch.ops import query_cuda, sw_cuda
    from sapling_tpu_torch.tools.bench_query_scale import load_for_queries

    def build(src):
        try:
            return sw_cuda.build_kernel(src)
        except Exception as e:   # a variant nvcc refuses is left out
            if src == query_cuda.SOURCE:
                raise
            log(f"query_ab: {src} does not build, left out: {e}")
            return None

    named = dict(zip([query_variant(v) for v in variants], variants))
    srcs = [query_cuda.SOURCE, *others, *named]
    with ThreadPoolExecutor(len(srcs)) as pool:
        paths = list(pool.map(build, srcs))
    srcs, paths = zip(*((s, p) for s, p in zip(srcs, paths) if p))
    others = [s for s in srcs[1:] if s not in named]
    variants = [named[s] for s in srcs[1:] if s in named]
    others += [s for s in srcs[1:] if s in named]
    builds = {src: build_report(path) for src, path in zip(srcs, paths)}
    for src, rep in builds.items():
        log(f"query_ab build {src}: " + json.dumps(rep))
    libs = [bind_query(path) for path in paths]
    rate = cs.random_sector_rate(dev)
    log(f"query_ab: random 32-byte sectors {rate['sectors_per_s'] / 1e9:.2f}"
        f"G/s ({rate['distinct']} distinct in {rate['ms']:.4f} ms)")
    out = dict(builds=builds, rate=rate, cases=[], memory=[])
    bigs, big_tables = [], []
    for art in arts:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        big = load_for_queries(art, dev)
        mem = dict(n=big.n, buckets=big.buckets,
                   device_bytes=big.device_bytes(),
                   records_bytes=sum(t.numel() * t.element_size()
                                     for t in big.query_records()),
                   peak_bytes=torch.cuda.max_memory_allocated(dev) - before)
        log(f"query_ab: {big.n} bp 2^{big.buckets}: device arrays and "
            f"record tables {mem['device_bytes'] / 1e9:.3f} GB (records "
            f"{mem['records_bytes'] / 1e9:.3f} GB), peak "
            f"{mem['peak_bytes'] / 1e9:.3f} GB over what was there before")
        out["memory"].append(mem)
        bigs.append(big)
        if "fancy" in kernels or "records" in kernels:
            t0 = time.perf_counter()
            big_tables.append(record_tables(big))
            log(f"query_ab: the {big.n} bp artifact's tables "
                f"({big_tables[-1][1]}) on the host in "
                f"{time.perf_counter() - t0:.1f} s")
    if "records" in kernels:
        out["records"] = records_ab(
            dev, [(idx21.to(dev), [torch.from_numpy(a).to(dev)
                                   for a in tables], REAL_TABLES),
                  *((big, [torch.from_numpy(a).to(dev) for a in t], note)
                    for big, (t, note) in zip(bigs, big_tables))],
            libs, srcs, variants)
    cases = query_cases(dev, idx21, bigs, tables,
                        [t if note == REAL_TABLES else None
                         for t, note in big_tables], kernels)
    if "plquery" in kernels:
        out["probe_sources"] = probe_sources(
            dev, idx21, bigs, next(c for c in cases if "srv" in c),
            rate["sectors_per_s"])
    # the record builders' variants change no query kernel: the query
    # cases run against the others alone
    pairs = [(src, lib) for src, lib, v in zip(
        others, libs[1:], [None] * (len(others) - len(variants)) + variants)
        if v not in RECORD_VARIANTS]
    for case in cases:
        name, call, b = case["name"], case["call"], case["lanes"]
        mine = call()
        q3 = case.get("fast3_q3")
        for src, lib in pairs:
            theirs = with_query_lib(lib, call, q3)
            if not torch.equal(theirs, mine):
                raise AssertionError(f"{src} disagrees with this tree: {name}")
        row = dict(name=name, against={}, **trace_bound(
            call, b, case["lane_bytes"], rate["sectors_per_s"]))
        extra = ""
        if "build" in case:
            row["build_ms"] = cs._time_ms(case["build"], dev, reps=3, warm=1)
            row["build_bytes"] = case["build_bytes"]
            extra = (f"; {row['sectors'] / b:.2f} sectors read a lane; node "
                     f"records {row['build_bytes']} bytes built in "
                     f"{row['build_ms']:.4f} ms")
        for src, lib in pairs:
            with_lib = lambda: with_query_lib(lib, call, q3)   # noqa: E731
            if not (getattr(lib, "arrays_plquery", False)
                    and case.get("kernel") == "plquery"):
                other_bound = None
            else:
                other_bound = with_query_lib(lib, lambda: trace_bound(
                    call, b, case["lane_bytes"], rate["sectors_per_s"]), q3)
            t_other, t_this = in_turns(with_lib, call, dev)
            med_o, med_t = statistics.median(t_other), statistics.median(
                t_this)
            row["against"][src] = dict(ms=t_other, this_ms=t_this,
                                       median=med_o, this_median=med_t,
                                       bound=other_bound)
            log(f"query_ab {name}: {src} {med_o:.4f} ms (median of "
                f"{len(t_other)}, {min(t_other):.4f}-{max(t_other):.4f}) in "
                f"turns with this tree's {med_t:.4f} ms "
                f"({min(t_this):.4f}-{max(t_this):.4f}): {med_o / med_t:.3f}x;"
                f" bound {row['bound_ms']:.4f} ms ({row['distinct']} distinct "
                f"sectors): {100 * row['bound_ms'] / med_t:.1f}% of this "
                f"tree's; at the measured rate {row['rate_bound_ms']:.4f} ms:"
                f" {100 * row['rate_bound_ms'] / med_t:.1f}%; lane "
                f"utilisation {100 * row['util']:.1f}%" + extra
                + ("" if other_bound is None else
                   f"; {src}'s own trace: {other_bound['distinct']} distinct "
                   f"sectors, bound {other_bound['bound_ms']:.4f} ms "
                   f"({100 * other_bound['bound_ms'] / med_o:.1f}%), at the "
                   f"measured rate {other_bound['rate_bound_ms']:.4f} ms "
                   f"({100 * other_bound['rate_bound_ms'] / med_o:.1f}%)"))
        out["cases"].append(row)
    return out


def with_nn_lib(lib, fn):
    """fn() with nn_predict_cuda's launches going to the library `lib`."""
    from sapling_tpu_torch.ops import nn_predict_cuda

    saved, nn_predict_cuda._LIB = nn_predict_cuda._LIB, lib
    try:
        return fn()
    finally:
        nn_predict_cuda._LIB = saved


# this tree's csrc/nn_predict.cu with one part changed, by name: the tile a
# block groups, the slot multiple a chunk's run starts at, the doubles that
# pad a chunk's row of parameters, a block a tile (a grid of every tile,
# not of the blocks the card holds at once), the chunk search over all of
# xb (no table of cells), or the histogram counted by __match_any_sync
# groups (one atomicAdd a group)
NN_VARIANTS = {
    "tile": (r"constexpr int kTile = \d+;", "constexpr int kTile = {};"),
    "align": (r"constexpr int kAlign = \d+;", "constexpr int kAlign = {};"),
    "row_pad": (r"return \(s \+ 1\) / 2 \* 2 \+ 2;",
                "return (s + 1) / 2 * 2 + {};"),
    "tile_a_block": (r"if \(needed < grid\) grid = needed;",
                     "grid = needed;"),
    "no_table": (r"count_le\(p, cell >= 0\.0f \? table\[g\] : 0, "
                 r"table\[g \+ 1\], xs\)",
                 "count_le(p, 0, table[kCells + 1], xs)"),
    "match_any": (r"if \(__all_sync[^\n]*\n(?:[^\n]*\n){4}\s*\}",
                  """{{
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        const int leader = __ffs(peers) - 1;
        int at = 0;
        if (bin >= 0 && lane == leader)
          at = atomicAdd(hist + bin, __popc(peers));
        at = __shfl_sync(0xffffffffu, at, leader);
        place[k] = at + __popc(peers & ((1u << lane) - 1u));
      }}"""),
}


def nn_variant(spec: str) -> str:
    """This tree's csrc/nn_predict.cu changed by `spec` ("tile=1024",
    "align=1", "row_pad=0", "tile_a_block", "no_table", "match_any":
    NN_VARIANTS), written beside the builds (ops.sw_cuda.BUILD_DIR);
    returns its path."""
    import re

    from sapling_tpu_torch.ops import nn_predict_cuda, sw_cuda

    name, _, value = spec.partition("=")
    pattern, repl = NN_VARIANTS[name]
    with open(nn_predict_cuda.SOURCE) as f:
        src, n = re.subn(pattern, repl.format(value), f.read())
    assert n == 1, f"{spec}: {n} matches in csrc/nn_predict.cu"
    os.makedirs(sw_cuda.BUILD_DIR, exist_ok=True)
    path = os.path.join(sw_cuda.BUILD_DIR, "nn_predict_" + re.sub(
        r"\W", "_", spec) + ".cu")
    with open(path, "w") as f:
        f.write(src)
    return path


# the phases of nn_predict_kernel, each ended by a __syncthreads (the last
# by the end of a tile): staging, the search table (and the histogram's
# first clearing), then for each tile the route and count, the scan, the
# scatter, the MLP and the ranks' store
NN_PHASES = ("stage", "table", "route", "scan", "scatter", "mlp", "output")


def nn_phase_source() -> str:
    """This tree's csrc/nn_predict.cu with thread 0 of each block adding
    the clock64() cycles since its last barrier to a counter of the phase
    that barrier ends (NN_PHASES, by instantiation), and a C entry point
    nn_phase_cycles(out, reset) that copies the counters out or clears
    them; written beside the builds (ops.sw_cuda.BUILD_DIR). Returns its
    path."""
    import re

    from sapling_tpu_torch.ops import nn_predict_cuda, sw_cuda

    add = ("if (threadIdx.x == 0) {{ const long long now = clock64(); "
           "atomicAdd(&g_phase[SHARED][S > 0][{}], "
           "(unsigned long long)(now - t_last)); t_last = now; }} {}")
    with open(nn_predict_cuda.SOURCE) as f:
        src = f.read()
    head, body = src.split("    nn_predict_kernel(const __grid_constant__ "
                           "NNArgs a) {\n", 1)
    body, tail = body.split("\n}\n", 1)
    body, n = re.subn(r"(\n\s*)__syncthreads\(\);",
                      lambda m: m.group(0) + m.group(1)
                      + add.format("ph", "++ph;"), body)
    assert n == len(NN_PHASES) - 1, f"{n} barriers in nn_predict_kernel"
    body = body.rstrip()
    assert body.endswith("}\n  }"), "the tile loop should end the kernel"
    body = (body[:-len("\n  }")] + "\n    "
            + add.format(len(NN_PHASES) - 1, "ph = 2;") + "\n  }")
    src = (head.replace("namespace {\n", "namespace {\n__device__ unsigned "
                        f"long long g_phase[2][2][{len(NN_PHASES)}];\n", 1)
           + "    nn_predict_kernel(const __grid_constant__ NNArgs a) {\n"
           + "  long long t_last = clock64();\n  int ph = 0;\n" + body
           + "\n}\n" + tail + f"""
extern "C" int nn_phase_cycles(unsigned long long* out, int reset) {{
  unsigned long long zero[2 * 2 * {len(NN_PHASES)}] = {{}};
  return (int)(reset ? cudaMemcpyToSymbol(g_phase, zero, sizeof(zero))
                     : cudaMemcpyFromSymbol(out, g_phase, sizeof(zero)));
}}
""")
    os.makedirs(sw_cuda.BUILD_DIR, exist_ok=True)
    path = os.path.join(sw_cuda.BUILD_DIR, "nn_predict_phases.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def nn_phases(dev, cases: dict, args, kw, reps: int = 10) -> dict:
    """{case: {phase: cycles a tile}} of nn_phase_source's build of
    nn_predict_kernel<true, 16> on each of `cases` ({name: x}), over reps
    calls after a warm one: the cycles of thread 0 of each block between
    its barriers, summed over blocks and divided by the tiles. A block
    shares its SM with others, so a phase's cycles are its own wall time,
    not the SM's."""
    import numpy as np
    import torch

    from sapling_tpu_torch.ops import nn_predict_cuda, sw_cuda

    lib = nn_predict_cuda.bind(sw_cuda.build_kernel(nn_phase_source()))
    lib.nn_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    tile = nn_predict_cuda.kernel_tile()
    out = {}
    for name, x in cases.items():
        def call():
            return nn_predict_cuda.nn_predict_cuda(x, *args, **kw)

        with_nn_lib(lib, call)
        torch.cuda.synchronize(dev)
        assert lib.nn_phase_cycles(None, 1) == 0
        for _ in range(reps):
            with_nn_lib(lib, call)
        torch.cuda.synchronize(dev)
        buf = (ctypes.c_ulonglong * (4 * len(NN_PHASES)))()
        assert lib.nn_phase_cycles(ctypes.addressof(buf), 0) == 0
        cyc = np.array(buf[:], np.float64).reshape(2, 2, -1)[1, 1]
        tiles = reps * -(-len(x) // tile)
        out[name] = {ph: float(c / tiles) for ph, c in zip(NN_PHASES, cyc)}
        log(f"nn phases {name} ({len(x)} lanes, {tiles // reps} tiles of "
            f"{tile}): cycles a tile of a block's thread 0 "
            + json.dumps({k: round(v) for k, v in out[name].items()})
            + f", in all {sum(out[name].values()):.0f}")
    return out


# bench_nn_query's default query count and seed: its k-mers drawn from the
# genome's
NN_BENCH_LANES, NN_BENCH_SEED = 5_000_000, 99


def nn_ab(dev, idx21, others: list[str], sm_clock_mhz: float,
          variants: list[str] = ()) -> dict:
    """Each of `others` (nn_predict.cu versions) and of this tree's source
    changed by each of `variants` (nn_variant) in turns with this tree's on
    chip_smoke.nn_untrained's model, on phase 5's 1M x, every genome k-mer,
    NN_BENCH_LANES k-mers drawn as bench_nn_query draws its queries, phase
    5's x sorted and chip_smoke's one-chunk batch; their builds'
    reports."""
    import statistics
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from sapling_tpu_torch.ops import nn_predict_cuda, sw_cuda

    others = [*others, *(nn_variant(v) for v in variants)]
    srcs = [nn_predict_cuda.SOURCE, *others]
    with ThreadPoolExecutor(len(srcs)) as pool:
        paths = list(pool.map(sw_cuda.build_kernel, srcs))
    builds = {src: build_report(path) for src, path in zip(srcs, paths)}
    for src, rep in builds.items():
        log(f"nn_ab build {src}: " + json.dumps(rep))
    libs = [nn_predict_cuda.bind(path) for path in paths]
    srv, kmers = cs.nn_untrained(dev, idx21)
    args, kw = cs.nn_model_args(srv)
    codes, _n_in = cs.query_codes(idx21.codes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = dict(builds=builds, cases=[])
    x5 = idx21.to(dev).query_inputs(codes)[0]
    bench = np.random.default_rng(NN_BENCH_SEED).integers(
        0, len(kmers), NN_BENCH_LANES)
    cases = {"phase 5 x": x5, "every k-mer": torch.from_numpy(kmers).to(dev),
             f"{NN_BENCH_LANES} k-mers": torch.from_numpy(kmers[bench]).to(
                 dev), **cs.nn_batches(x5, srv)}
    out["phases"] = nn_phases(dev, cases, args, kw)
    for name, x in cases.items():
        def call():
            return nn_predict_cuda.nn_predict_cuda(x, *args, **kw)

        mine = call()
        row = dict(name=name, lanes=len(x), against={},
                   plain_ms=cs._time_ms(lambda: nn_predict_cuda.nn_predict(
                       x, *args, **kw), dev, reps=3, warm=1),
                   **cs.nn_bound_ms(len(x), srv.xb.shape[0], cs.NN_UNITS,
                                    sm_clock_mhz, sms))
        for src, lib in zip(others, libs[1:]):
            if not torch.equal(with_nn_lib(lib, call), mine):
                raise AssertionError(f"{src} disagrees with this tree: {name}")
            t = {"other": [], "this": [], "other_dev": [], "this_dev": []}

            def other():
                return with_nn_lib(lib, call)

            for _ in range(AB_ROUNDS):
                for who, fn in (("other", other), ("this", call),
                                ("this", call), ("other", other)):
                    t[who].append(cs._time_ms(fn, dev))
                    t[who + "_dev"].append(cs.kernel_device_ms(fn, dev))
            med = {k: statistics.median(v) for k, v in t.items()}
            row["against"][src] = dict(times=t, medians=med)
            log(f"nn_ab {name} ({len(x)} lanes): {src} on the card "
                f"{med['other_dev']:.4f} ms, a call {med['other']:.4f} ms; "
                f"this tree's {med['this_dev']:.4f} ms, a call "
                f"{med['this']:.4f} ms (medians of {len(t['this'])}, in "
                f"turns): {med['other_dev'] / med['this_dev']:.3f}x on the "
                f"card; bound {row['bound_ms']:.4f} ms by {row['bound_by']}:"
                f" {100 * row['bound_ms'] / med['this_dev']:.1f}% / "
                f"{100 * row['bound_ms'] / med['other_dev']:.1f}% of it; "
                f"plain {row['plain_ms']:.3f} ms")
        out["cases"].append(row)
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
            didx.query_device(*inputs, length, stats=True)
            r = dict(form=cs.query_form(didx, inputs, length),
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
    def opt(name):
        return [a.split("=", 1)[1] for a in argv
                if a.startswith(f"--{name}=")]

    against, against_query, big, against_nn, nn_variants = (
        opt("against"), opt("against-query"), opt("big"), opt("against-nn"),
        [v for o in opt("nn-variants") for v in o.split(",")])
    query_variants = [v for o in opt("query-variants") for v in o.split(",")]
    kernels = [v for o in opt("query-kernels") for v in o.split(",")]
    query_only = bool(against_query or query_variants or kernels)
    kernels = kernels or QUERY_KERNELS
    argv = [a for a in argv if not a.startswith("--")]
    out_path = argv[0] if argv else os.path.join(
        cs.ROOT, "chiprun_out", "measure.json")
    info = cs.card()
    log(f"card: {info['name_power']}, max SM clock {info['sm_clock_max']}, "
        f"{info['uuid']} on host {info['host']}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    sm_clock_mhz = float(info["sm_clock_max"].split()[0])
    res = dict(card=info, torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda", 0)

    if against_nn or nn_variants:
        _seq, _idx16, idx21, _t = cs.build_indexes(cs.GENOME_N)
        res["nn_ab"] = nn_ab(dev, idx21, against_nn, sm_clock_mhz,
                             nn_variants)
    elif query_only:
        # the 46 Mbp artifact builds in a child beside the 4.6 Mbp index
        with tempfile.TemporaryDirectory(prefix="chip_measure_") as td:
            scale = cs.start_scale_build(td)
            try:
                _seq, _idx16, idx21, tables = cs.build_indexes(cs.GENOME_N)
                cs.finish_scale_build(scale)
                res["query_ab"] = query_ab(
                    dev, idx21, [scale[1], *big], against_query, tables,
                    query_variants, kernels)
            finally:
                if scale[0].poll() is None:
                    os.killpg(scale[0].pid, signal.SIGKILL)
                    scale[0].wait()
    else:
        seq, idx16, idx21, tables = cs.build_indexes(cs.GENOME_N)
        sw_cuda.build_kernel()       # before CUDA
        res["sw"] = sw_times(dev, sm_clock_mhz,
                             against[0] if against else None)
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
