"""The counted slice: the query kernels' own work counters over a run's
traffic, read by the `query kernels` layer's counter metrics.

With `stats=True` the program's query kernels write five counts a query
(`sapling_tpu_torch.ops.query_cuda.STAT_ROWS`, kept in `LAST_STATS`):
probes, 32-byte sectors read, phase C (stride) steps, phase D (bisection)
steps and the sectors of the packed genome among them. Such a call adds
stores to the kernel and a sync to the call, so it is never timed: the
slice runs in a `--trace 1` run only, after the traced slice, whose
profiler has closed, and after the window, whose numbers are taken.

The slice sends each length's batch of the run once through the entry
the mix names, with stats: the same rows the window sent, packed by the
entry's `prepare` on an index loaded anew from the run's artifact (the
harness hands its readers the run, not its index). It keeps each length's
counts in `run.counts` ({length: {row name: int32 [B]}}), made on the
first read and shared by the readers. A row the program does not write
is absent, and its metric is left out; a run that traced no card makes
no slice (`run.counts` None).
"""

from __future__ import annotations

import gc
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the stats call of each entry (portbench/entries/<entry>.py): one
# request of the entry's call, with the kernel's counters on
STATS_CALLS = {
    "query_device": lambda index, inputs, length: index.query_device(
        *inputs, length, stats=True),
    "binsearch_device": lambda index, inputs, length: index.binsearch_device(
        inputs, length, stats=True),
}
# lanes a warp: the kernels map query b to lane b % 32 of warp b // 32
WARP = 32


def counts(run):
    """The run's counted slice ({length: {row name: int32 numpy [B]}}),
    made on the first call; None where the run traced no card or its
    entry has no stats call."""
    if not hasattr(run, "counts"):
        run.counts = count_slice(run) if traced_the_card(run) else None
    return run.counts


def traced_the_card(run) -> bool:
    """Whether the run's traced slice launched kernels on a card (a trace
    the harness took there, not one a test planted)."""
    if run.trace is None or not run.trace.launches:
        return False
    import torch
    return torch.cuda.is_available()


def count_slice(run):
    """Each length's batch of the run once through its entry with stats
    (see the module's docstring); the counts, or None for an entry
    without a stats call."""
    import torch

    from sapling_tpu_torch.index.sapling import SaplingIndex
    from sapling_tpu_torch.ops import query_cuda

    from .harness import PACKAGE, SETUP_THREADS
    from .index_cache import QUERY_SKIP, ensure_artifact

    cell = run.cell
    name = cell.mix["entry"]
    if name not in STATS_CALLS:
        return None
    t = time.perf_counter()
    entry = cell.module("entries", name)
    device = torch.device("cuda", torch.cuda.current_device())
    artifact, _ = ensure_artifact(cell.root,
                                  os.path.join(cell.root, PACKAGE, ".cache"),
                                  cell.config, cell.config_file)
    index = SaplingIndex.load(artifact, skip=QUERY_SKIP, mmap=True,
                              device=device)
    entry.ready(index)
    out = {}
    with ThreadPoolExecutor(SETUP_THREADS) as pool:
        for length in sorted(run.batches):
            inputs = entry.prepare(index, run.batches[length], pool)
            STATS_CALLS[name](index, inputs, length)
            st = query_cuda.LAST_STATS
            out[length] = {row: v.cpu().numpy() for row, v in st.items()
                           if row not in ("C", "D", "trace")}
            report(length, out[length], st["C"], st["D"])
            del inputs
    query_cuda.LAST_STATS.clear()
    del index
    gc.collect()
    torch.cuda.empty_cache()
    print(f"portbench: counted slice {time.perf_counter() - t:.3f} s",
          file=sys.stderr, flush=True)
    return out


def report(length: int, rows: dict, c: int, d: int) -> None:
    """One length's sums on standard error, and the deepest steps of rows
    2 and 3 beside the kernel's own (they agree)."""
    sums = " ".join(f"{row} {int(v.sum(dtype=np.int64))}"
                    for row, v in rows.items())
    deepest = " ".join(f"{row} max {int(rows[row].max(initial=0))}"
                       for row in ("c_steps", "d_steps") if row in rows)
    print(f"portbench: counted L={length} queries {len(rows['probes'])} "
          f"{sums}; {deepest}; depth C {c} D {d}", file=sys.stderr,
          flush=True)


def per_query(run, row: str):
    """The mean of a row over every query of the slice, each length's
    batch weighted equally, as the schedule sends them; None without the
    row."""
    c = counts(run)
    if not c or any(row not in rows for rows in c.values()):
        return None
    return float(np.mean([rows[row].mean(dtype=np.float64)
                          for rows in c.values()]))


def lane_use(probes) -> tuple[int, int]:
    """(Σ probes, Σ over warps of 32 × the warp's deepest lane's probes)
    of one batch's probe counts in the batch's order: a warp of 32
    consecutive queries runs as long as its deepest lane (a last warp
    short of 32 is padded with lanes of no probe)."""
    p = np.asarray(probes, np.int64)
    warps = np.pad(p, (0, -len(p) % WARP)).reshape(-1, WARP)
    return int(p.sum()), int(WARP * warps.max(1).sum())


def lane_use_pct(run):
    """The share of the warps' probe slots that do a lane's probe, over
    every batch of the slice; None without counts."""
    c = counts(run)
    if not c or any("probes" not in rows for rows in c.values()):
        return None
    used, slots = np.sum([lane_use(rows["probes"]) for rows in c.values()],
                         axis=0)
    return 100.0 * used / slots if slots else None
