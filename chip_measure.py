#!/usr/bin/env python3
"""Chip measurements of the PyTorch port on one GPU (the numbers in PERF.md).

    python3 chip_measure.py [out.json] [--against=path/to/other/sw.cu]
    python3 chip_measure.py [out.json] --against-query=path/to/query.cu ...
        [--big=path/to/artifact.stpu.npz]
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

With --against-query (one or more), it measures only this instead:

  query_ab: each other version of csrc/query.cu (the same C entry points,
           or those of a version whose pruned search reads the llcp/rlcp
           tables rather than node records; built with the same flags) timed
           in turns with this tree's (other, this, this, other, AB_ROUNDS
           times; CUDA events) on the same CUDA tensors, their positions
           held equal, in these cases, each in chip_smoke's
           order and shuffled (chip_smoke.shuffled): the 4.6 Mbp k=21 index
           fast3 L=21 and packed L=101 without prefix arrays, chip_smoke
           phase 8's 46 Mbp artifact (no prefix arrays) at L=21 and 101,
           and the binary search at L=21 on both, and the llcp/rlcp-pruned
           search at L=21 with and without prefix64 and at L=101 without
           on the 4.6 Mbp index, and at L=21 and 101 on the 46 Mbp
           artifact (its tables from its LCP: scale_tables) (--big:
           another artifact in place of the 46 Mbp one); each case's bound
           (chip_smoke.query_bound_ms over this build's sector trace) and
           lane utilisation (chip_smoke.lane_utilisation), and for the
           pruned search the sectors a lane read and its node records'
           build time and bytes; and of each
           build the registers, stack and spills of every kernel (nvcc's
           -Xptxas -v log) and the CALL instructions in its SASS by target
           (cuobjdump): the int64 division subroutine's.

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
        m = re.search(r"(plquery_kernel|fancy_binsearch_kernel|"
                      r"fancy_nodes_kernel|binsearch_kernel)"
                      r"I(?:Li(\d+)E)?([il])E", mangled)
        if not m:
            return mangled
        rev = {"i": "int32", "l": "int64"}[m.group(3)]
        return f"{m.group(1)}<{m.group(2) + ', ' if m.group(2) else ''}{rev}>"

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


def bind_query(path: str):
    """A query library with its C entry points typed: this tree's, or one
    from before the node records (no fancy_nodes_launch), whose pruned
    search takes TABLES_FANCY's arguments (with_query_lib launches it
    through launch_fancy_tables)."""
    from sapling_tpu_torch.ops import query_cuda, sw_cuda

    if hasattr(ctypes.CDLL(path), "fancy_nodes_launch"):
        return query_cuda.bind(path)
    sig = {k: v for k, v in query_cuda.SIGNATURES.items()
           if k != "fancy_nodes_launch"}
    lib = sw_cuda.bind_lib(path, dict(sig,
                                      fancy_binsearch_launch=TABLES_FANCY))
    lib.tables_fancy = True
    return lib


def launch_fancy_tables(lib, stream, packed, rev, llcp, rlcp, prefix, _nodes,
                        q_words, out, lane, depth, trace, *, n: int,
                        length: int, form: str) -> int:
    """query_cuda.launch_fancy for a library from before the node records:
    the same call without them."""
    import torch

    from sapling_tpu_torch.ops.query_cuda import PROBES, _ptr

    return lib.fancy_binsearch_launch(
        packed.data_ptr(), packed.shape[0], rev.data_ptr(),
        int(rev.dtype == torch.int64), llcp.data_ptr(), rlcp.data_ptr(),
        _ptr(prefix) if form == "prefix64" else None, q_words.data_ptr(),
        out.data_ptr(), _ptr(lane), _ptr(depth), _ptr(trace),
        q_words.shape[1], n, length, 0 if trace is None else trace.shape[1],
        PROBES[form], stream)


def with_query_lib(lib, fn):
    """fn() with query_cuda's launches going to the library `lib` (one from
    before the node records through launch_fancy_tables)."""
    from sapling_tpu_torch.ops import query_cuda

    saved = query_cuda._LIB, query_cuda.launch_fancy
    query_cuda._LIB = lib
    if getattr(lib, "tables_fancy", False):
        query_cuda.launch_fancy = launch_fancy_tables
    try:
        return fn()
    finally:
        query_cuda._LIB, query_cuda.launch_fancy = saved


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


def query_cases(dev, idx21, big, tables, big_tables):
    """The query_ab cases, each in chip_smoke's order and shuffled: dicts
    of name, call(**stats) -> positions, lanes, coalesced bytes a lane and,
    for the pruned search, the build of its node records (made once for
    an index and its tables, outside the timed calls)."""
    import torch

    from sapling_tpu_torch.ops import query_cuda

    def plquery(tag, idx, length, codes):
        args, kw, form, lane_bytes = cs.plquery_inputs(idx, length, codes)
        return dict(name=f"{tag} L={length} {form}", call=lambda **st:
                    query_cuda.plquery_cuda(*args, **st, **kw),
                    lanes=len(codes), lane_bytes=lane_bytes)

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

    lr = [torch.from_numpy(a).to(dev) for a in tables]
    big_lr = [torch.from_numpy(a).to(dev) for a in big_tables]
    didx, bare = idx21.to(dev), cs.without_prefix(idx21).to(dev)
    cases = []
    for order in ("smoke", "shuffled"):
        def codes_of(idx, length):
            codes, _n_in = cs.query_codes(idx.codes, length)
            return cs.shuffled(codes) if order == "shuffled" else codes

        tag = f"{idx21.n} bp {order}"
        cases += [plquery(tag, didx, cs.QUERY_LEN,
                          codes_of(idx21, cs.QUERY_LEN)),
                  plquery(tag + " no_prefix", bare, 101,
                          codes_of(idx21, 101))]
        big_tag = f"{big.n} bp {order}"
        cases += [plquery(big_tag, big, length, codes_of(big, length))
                  for length in cs.SCALE_LENGTHS]
        cases += [binsearch(tag, didx, codes_of(idx21, cs.QUERY_LEN)),
                  binsearch(big_tag, big, codes_of(big, cs.QUERY_LEN)),
                  fancy(tag, didx, lr, codes_of(idx21, cs.QUERY_LEN)),
                  fancy(tag + " no_prefix", bare, lr,
                        codes_of(idx21, cs.QUERY_LEN)),
                  fancy(tag + " no_prefix", bare, lr, codes_of(idx21, 101))]
        cases += [fancy(big_tag, big, big_lr, codes_of(big, length))
                  for length in cs.SCALE_LENGTHS]
    return cases


def query_ab(dev, idx21, art: str, others: list[str], tables) -> dict:
    """Each of `others` (query.cu versions) in turns with this tree's on
    query_cases; their builds' reports (build_report)."""
    import statistics
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from sapling_tpu_torch.ops import query_cuda, sw_cuda
    from sapling_tpu_torch.tools.bench_query_scale import load_for_queries

    srcs = [query_cuda.SOURCE, *others]
    with ThreadPoolExecutor(len(srcs)) as pool:
        paths = list(pool.map(sw_cuda.build_kernel, srcs))
    builds = {src: build_report(path) for src, path in zip(srcs, paths)}
    for src, rep in builds.items():
        log(f"query_ab build {src}: " + json.dumps(rep))
    libs = [bind_query(path) for path in paths]
    big = load_for_queries(art, dev)
    t0 = time.perf_counter()
    big_tables = scale_tables(big)
    log(f"query_ab: the {big.n} bp artifact's llcp/rlcp tables on the host "
        f"in {time.perf_counter() - t0:.1f} s")
    out = dict(builds=builds, cases=[])
    for case in query_cases(dev, idx21, big, tables, big_tables):
        name, call, b = case["name"], case["call"], case["lanes"]
        mine = call()
        for src, lib in zip(others, libs[1:]):
            theirs = with_query_lib(lib, call)
            if not torch.equal(theirs, mine):
                raise AssertionError(f"{src} disagrees with this tree: {name}")
        call(stats=True, trace=cs.QK_TRACE)
        st = query_cuda.LAST_STATS
        tr = st["trace"]
        distinct = int(torch.unique(tr[tr >= 0]).numel())
        probes = st["probes"].cpu()
        row = dict(name=name, bound_ms=cs.query_bound_ms(
            distinct, b, case["lane_bytes"]),
                   util=cs.lane_utilisation(probes),
                   probes=int(probes.sum()),
                   sectors=int(st["sectors"].sum()), against={})
        extra = ""
        if "reads" in st:
            row["reads"] = int(st["reads"].sum())
            row["build_ms"] = cs._time_ms(case["build"], dev, reps=3, warm=1)
            row["build_bytes"] = case["build_bytes"]
            extra = (f"; sectors a lane: {row['sectors'] / b:.2f} of the "
                     f"first design, {row['reads'] / b:.2f} read; node "
                     f"records {row['build_bytes']} bytes built in "
                     f"{row['build_ms']:.4f} ms")
        del tr, st
        query_cuda.LAST_STATS.clear()
        for src, lib in zip(others, libs[1:]):
            t_other, t_this = [], []
            for _ in range(AB_ROUNDS):
                t_other.append(cs._time_ms(lambda: with_query_lib(lib, call),
                                           dev))
                t_this += [cs._time_ms(call, dev), cs._time_ms(call, dev)]
                t_other.append(cs._time_ms(lambda: with_query_lib(lib, call),
                                           dev))
            med_o, med_t = statistics.median(t_other), statistics.median(
                t_this)
            row["against"][src] = dict(ms=t_other, this_ms=t_this,
                                       median=med_o, this_median=med_t)
            log(f"query_ab {name}: {src} {med_o:.4f} ms (median of "
                f"{len(t_other)}, {min(t_other):.4f}-{max(t_other):.4f}) in "
                f"turns with this tree's {med_t:.4f} ms "
                f"({min(t_this):.4f}-{max(t_this):.4f}): {med_o / med_t:.3f}x;"
                f" bound {row['bound_ms']:.4f} ms: {100 * row['bound_ms'] / med_t:.1f}%"
                f" / {100 * row['bound_ms'] / med_o:.1f}% of it; lane "
                f"utilisation {100 * row['util']:.1f}%" + extra)
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
    def opt(name):
        return [a.split("=", 1)[1] for a in argv
                if a.startswith(f"--{name}=")]

    against, against_query, big, against_nn, nn_variants = (
        opt("against"), opt("against-query"), opt("big"), opt("against-nn"),
        [v for o in opt("nn-variants") for v in o.split(",")])
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
    elif against_query and big:
        _seq, _idx16, idx21, tables = cs.build_indexes(cs.GENOME_N)
        res["query_ab"] = query_ab(dev, idx21, big[0], against_query,
                                   tables)
    elif against_query:
        # the 46 Mbp artifact builds in a child beside the 4.6 Mbp index
        with tempfile.TemporaryDirectory(prefix="chip_measure_") as td:
            scale = cs.start_scale_build(td)
            try:
                _seq, _idx16, idx21, tables = cs.build_indexes(cs.GENOME_N)
                cs.finish_scale_build(scale)
                res["query_ab"] = query_ab(dev, idx21, scale[1],
                                           against_query, tables)
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
