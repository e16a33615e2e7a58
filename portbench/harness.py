"""The benchmark of the PyTorch / CUDA port (`sapling_tpu_torch`).

One run measures one cell of BENCHMARK.json: a configuration (a genome
and the index built on it) under a traffic mix, on the card. It

  1. refuses to run without the cards the cell asks for;
  2. sets up: the configuration's genome (`genome.py`) and the program's
     index artifact (`index_cache.py`), both made once in a checkout, the
     program's kernels, the index on the card, and the mix's batches made
     from `--seed` (`traffic.py`), one a length, and prepared on the card
     by the entry the mix names (`entries/<entry>.py`); every batch is
     sent once to warm;
  3. measures for `--seconds`: one client, one request in flight, each
     request a batch of queries of one length;
  4. with `--trace 1` profiles a further slice of requests
     (`trace_reader.py`) and reads the cell's per-layer metrics, each from
     its own reader (`metrics/<name>.py`);
  5. frees the program's state and judges a sample of the answers the
     window's requests returned, drawn from the seed with every length in
     it, against the plain reference (`reference.py`);
  6. prints the numbers it compared beside their limits, last on standard
     error, and one JSON line, last on standard output.

Configurations, mixes, entries and metrics are found by the names in
BENCHMARK.json, so a later cell, mix or metric adds files and entries and
edits none.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from .genome import cached_genome, codes_of
from .index_cache import QUERY_SKIP, ensure_artifact
from .roofline import buckets_for
from .trace_reader import read_trace
from .traffic import LookupTraffic

PACKAGE = "portbench"
# top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "sapling_tpu")
# the host annotation around the traced slice
TRACE_WINDOW = "portbench.traced"
# blocks of one request a length profiled after the window
TRACED_BLOCKS = 100
# answers of this many of the window's requests of each length are judged
KEPT_PER_LENGTH = 5
# host threads that make and prepare the batches in set-up
SETUP_THREADS = 4


class NotRunnable(Exception):
    """The run cannot measure: it prints the reason and no result."""


def forbidden_modules(names) -> list[str]:
    """The module names whose top-level name (before the first dot),
    compared whole, is in FORBIDDEN."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_module(path: str, name: str):
    """The Python file at `path` as a module named `name`."""
    if not os.path.exists(path):
        raise NotRunnable(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: str) -> dict:
    if not os.path.exists(path):
        raise NotRunnable(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A cell of BENCHMARK.json with its files read."""
    root: str
    bench: dict
    workload: dict
    config: dict
    config_file: str
    mix: dict

    @classmethod
    def find(cls, root: str, name: str) -> "Cell":
        bench = read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise NotRunnable(f"no workload {name!r} in BENCHMARK.json")
        workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        config_file = os.path.join(root, configs[workload["config"]]["file"])
        mix = read_json(os.path.join(root, PACKAGE, "traffic",
                                     f"{workload['traffic']}.json"))
        return cls(root, bench, workload, read_json(config_file),
                   config_file, mix)

    def metrics(self, kind: str) -> list[dict]:
        """The cell's metrics of `kind` (end_to_end or per_layer)."""
        name = self.workload["name"]
        return [m for m in self.bench[kind]
                if name in m.get("workloads", [name])]

    def module(self, folder: str, name: str):
        return load_module(os.path.join(self.root, PACKAGE, folder,
                                        f"{name}.py"),
                           f"{PACKAGE}_{folder}_{name}")


@dataclass
class Run:
    """What a run recorded, as the per-layer metrics' readers read it."""
    cell: Cell
    k: int
    buckets: int
    batches: dict                       # length -> uint8 [B, L]
    spans: dict = field(default_factory=dict)       # set-up, seconds
    requests: list = field(default_factory=list)    # lengths
    host_call_s: list = field(default_factory=list)
    latency_ms: list = field(default_factory=list)
    window_s: float = 0.0
    trace: object = None                # trace_reader.Trace
    traced: list = field(default_factory=list)      # lengths


class Kept:
    """A sample of the window's answers: for each length, up to `per`
    requests' outputs, each of the requests equally likely (reservoir
    sampling from the seed)."""

    def __init__(self, seed: int, per: int):
        self.rng = np.random.default_rng(
            np.random.SeedSequence([seed % (1 << 64), 3]))
        self.per = per
        self.kept: dict = {}
        self.seen: dict = {}

    def offer(self, length: int, out) -> None:
        seen = self.seen.get(length, 0) + 1
        self.seen[length] = seen
        outs = self.kept.setdefault(length, [])
        if len(outs) < self.per:
            outs.append(out)
        else:
            j = int(self.rng.integers(0, seen))
            if j < self.per:
                outs[j] = out

    def items(self):
        """(length, output) of every kept answer."""
        return [(length, out) for length, outs in self.kept.items()
                for out in outs]


def sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


class Clock:
    """A request's latency on the host clock, as a caller waits for it:
    from the call to the host seeing the card's work done (a CUDA event
    recorded after the call, synchronized)."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        if self.cuda:
            self.end = torch.cuda.Event()

    def request(self, call):
        """(output, host seconds in the call, latency ms)."""
        h0 = time.perf_counter()
        out = call()
        h1 = time.perf_counter()
        if self.cuda:
            self.end.record()
            self.end.synchronize()
        return out, h1 - h0, (time.perf_counter() - h0) * 1e3


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or ''."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return res.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return ""


def info(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def run_cell(args, root: str, t0: float, require_card: bool = True,
             wrap_call=None) -> dict:
    """Measure the cell and return the result line's object. `wrap_call`
    (tests) wraps the entry's call."""
    import torch

    cell = Cell.find(root, args.workload)
    chips = int(cell.workload["chips"])
    if require_card:
        if not torch.cuda.is_available():
            raise NotRunnable("no CUDA device: this benchmark measures the "
                              "card and does not fall back to the CPU")
        if torch.cuda.device_count() < chips:
            raise NotRunnable(f"the cell needs {chips} cards, "
                              f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    from sapling_tpu_torch.index.sapling import SaplingIndex

    cache = os.path.join(root, PACKAGE, ".cache")
    config, mix = cell.config, cell.mix
    entry = cell.module("entries", mix["entry"])
    genome = codes_of(np.asarray(cached_genome(
        config["genome"], os.path.join(cache, "genome"))))
    t = time.perf_counter()
    artifact, built = ensure_artifact(root, cache, config, cell.config_file)
    if built:
        info(f"index built in {time.perf_counter() - t:.3f} s (first run "
             "in this checkout)")
    if device.type == "cuda":
        t = time.perf_counter()
        entry.build()
        info(f"kernels ready in {time.perf_counter() - t:.3f} s")

    k = int(config["index"]["k"])
    run = Run(cell=cell, k=k,
              buckets=buckets_for(len(genome), int(config["index"]["max_mem"])),
              batches={})
    t = time.perf_counter()
    index = SaplingIndex.load(artifact, skip=QUERY_SKIP, mmap=True,
                              device=device)
    entry.ready(index)
    sync(device)
    run.spans["index_ready"] = time.perf_counter() - t
    if index.buckets != run.buckets:
        raise NotRunnable(
            f"the index has 2^{index.buckets} buckets, the configuration's "
            f"rule (maxMem {config['index']['max_mem']}) gives "
            f"2^{run.buckets}: another deployment")
    index_bytes = (torch.cuda.memory_allocated(device)
                   if device.type == "cuda" else 0)

    traffic = LookupTraffic(mix, args.seed)
    inputs = {}
    t = time.perf_counter()
    lengths = traffic.lengths
    with ThreadPoolExecutor(SETUP_THREADS) as pool:
        run.batches = dict(zip(lengths, pool.map(
            lambda length: traffic.batch(genome, length), lengths)))
        for length in lengths:
            inputs[length] = entry.prepare(index, run.batches[length], pool)
    call = entry.call if wrap_call is None else wrap_call(entry.call)
    clock = Clock(device)
    for length in lengths:
        clock.request(lambda: call(index, inputs[length], length))
    # room in the allocator's cache for the kept answers, so that the
    # window allocates no device memory anew
    spare = [torch.empty(run.batches[length].shape[0], dtype=torch.int64,
                         device=device)
             for length in lengths for _ in range(KEPT_PER_LENGTH + 1)]
    del spare
    sync(device)
    run.spans["traffic_ready"] = time.perf_counter() - t
    kept = Kept(args.seed, KEPT_PER_LENGTH)
    schedule = traffic.schedule()
    if device.type == "cuda":
        # the peak is the window's: the index, the prepared batches, a
        # request's answers and the kept answers, not set-up's transients
        inputs_bytes = torch.cuda.memory_allocated(device) - index_bytes
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    # the requests' thread on one fixed core: unpinned, the core a run
    # landed on moved its host time a request by up to a third
    cpus = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {max(cpus)})
    # no collector pauses inside the window: it allocates few objects
    gc.collect()
    gc.disable()
    start = time.perf_counter()
    deadline = start + args.seconds
    queries = 0
    while True:
        length = next(schedule)
        out, host_s, ms = clock.request(
            lambda: call(index, inputs[length], length))
        run.requests.append(length)
        run.host_call_s.append(host_s)
        run.latency_ms.append(ms)
        kept.offer(length, out)
        queries += run.batches[length].shape[0]
        del out
        if time.perf_counter() >= deadline:
            break
    run.window_s = time.perf_counter() - start
    gc.enable()
    sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    result_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "kind": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                     "count": chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        trace_slice(run, index, inputs, call, schedule, clock, device,
                    cache, cell.workload["name"])
        result_device["busy_s"] = run.trace.busy_s()
        result_device["window_s"] = run.trace.window_s
        breakdown = {"device_ops": run.trace.top_device_ops(),
                     "idle_gaps": run.trace.idle_gaps()}
        metrics = per_layer(cell, run)
    else:
        lat = np.asarray(run.latency_ms)
        values = {"lookup_qps": queries / run.window_s,
                  "lookup_p95_ms": float(np.percentile(lat, 95)),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.metrics("end_to_end") if m["name"] in values}
        info(f"window {run.window_s:.4f} s, {len(run.requests)} requests, "
             f"{queries} queries; latency median "
             f"{float(np.median(lat)):.6f} ms; host call mean "
             f"{1e6 * float(np.mean(run.host_call_s)):.3f} us")
    info(f"set-up {setup_s:.3f} s: index ready "
         f"{run.spans['index_ready']:.4f} s, traffic and warm-up "
         f"{run.spans['traffic_ready']:.3f} s")
    if device.type == "cuda":
        kept_bytes = sum(out.numel() * out.element_size()
                         for _, out in kept.items())
        info(f"device memory: window peak {peak} bytes; the index "
             f"{index_bytes}, the prepared batches {inputs_bytes}, the kept "
             f"answers {kept_bytes}")
    os.sched_setaffinity(0, cpus)
    if device.type == "cuda":
        info(f"card: {power_limit()}")

    # the program's state goes before the reference runs
    answers = kept.items()
    del index, inputs, call, entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge_answers(run, genome, answers, device)
    bad = forbidden_modules(sys.modules)
    if bad:
        raise NotRunnable(f"modules loaded that the port may not load: {bad}")
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": len(run.requests), "failed": 0,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def trace_slice(run: Run, index, inputs, call, schedule, clock: Clock,
                device, cache: str, name: str) -> None:
    """Profile TRACED_BLOCKS blocks of requests, sent as the window sends
    them, after the window, and read the trace into run.trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def annotated(length):
        with record_function("portbench.call"):
            return call(index, inputs[length], length)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    count = TRACED_BLOCKS * len(run.cell.mix["lengths"])
    with profile(activities=activities) as prof:
        with record_function(TRACE_WINDOW):
            for _ in range(count):
                length = next(schedule)
                clock.request(lambda: annotated(length))
                run.traced.append(length)
    path = os.path.join(cache, "traces", f"{name}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    run.trace = read_trace(path, TRACE_WINDOW)
    if not run.trace.clipped():
        raise NotRunnable(
            f"the trace holds {run.trace.launches} kernel launches and no "
            f"operation on the card ({path}): the profiler dropped it")


def per_layer(cell: Cell, run: Run) -> dict:
    """The cell's per-layer metrics, each from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.metrics("per_layer"):
        value = cell.module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge_answers(run: Run, genome: np.ndarray, answers, device) -> dict:
    """The reference's judgement of the kept answers: the number of wrong
    answers beside its limit, 0 (an exact comparison)."""
    import torch

    from .reference import KeyTable, judge

    table = KeyTable(torch.from_numpy(np.ascontiguousarray(genome)).to(device))
    counts = dict.fromkeys(("missed", "out_of_range", "absent",
                            "absent_unanswered"), 0)
    compared = 0
    for length, out in answers:
        rows = torch.from_numpy(run.batches[length]).to(device)
        if out.shape != (rows.shape[0],):
            counts["missed"] += rows.shape[0]
            continue
        for name, v in judge(table, rows, out).items():
            counts[name] += v
        compared += rows.shape[0]
    info(f"judged {compared} answers of {len(answers)} requests "
         f"(lengths {sorted({length for length, _ in answers})}): "
         f"{counts['missed']} missed, {counts['out_of_range']} out of range; "
         f"{counts['absent']} queries absent from the genome, "
         f"{counts['absent_unanswered']} of them answered -1")
    return {"wrong_answers": {
        "value": counts["missed"] + counts["out_of_range"], "limit": 0}}


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float, root: str, require_card: bool = True,
         wrap_call=None) -> int:
    """Run one cell; 0 with a result line, else the reason on standard
    error and no result."""
    args = parse(argv)
    cache = os.path.join(root, PACKAGE, ".cache")
    # kernel caches of the program, at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    try:
        result = run_cell(args, root, t0, require_card, wrap_call)
    except NotRunnable as e:
        info(f"not measured: {e}")
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
