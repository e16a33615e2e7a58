"""Fork-based parallel map for host-side (NumPy) build stages.

The multi-Gbp index build is dominated by embarrassingly chunkable
NumPy sweeps (k-mer scan, per-bucket checkpoint reduction, error
audit — tools/build_big_index.py). This helper fans chunks out over
`fork` workers: the children inherit the parent's big read-only arrays
copy-on-write (no serialization of inputs), and only the per-chunk
results ride the result pipe.

The reference does all of this serially in C++ (two full-genome sweeps,
src/sapling_api.h:384-487); the equivalent here must build GRCh38-scale
indexes in minutes, not hours, on a small host.
"""

from __future__ import annotations

import os

# Big read-only inputs for the current parallel region. Set by run_forked
# immediately before the fork so workers see them via copy-on-write
# inheritance; keyed per call-site to stay re-entrant across nesting.
_CTX: dict = {}


def ctx() -> dict:
    return _CTX


def default_workers() -> int:
    env = os.environ.get("SAPLING_BUILD_WORKERS")
    if env:
        return max(1, int(env))
    return max(1, min(4, os.cpu_count() or 1))


def run_forked(fn, spans, context: dict, workers: int | None = None):
    """Run fn(span) for every span, returning results as a list in
    ARBITRARY order (workers race; make spans self-identifying).

    fn must be a module-level function (pickled by reference); it reads
    its big inputs from parhost.ctx(), which the forked children inherit
    without copying. workers=1 (or a single span) degrades to a serial
    loop with identical semantics.
    """
    global _CTX
    spans = list(spans)
    if workers is None:
        workers = default_workers()
    workers = min(workers, len(spans)) or 1
    prev = _CTX
    _CTX = context
    try:
        if workers <= 1:
            return [fn(s) for s in spans]
        from multiprocessing import get_context

        with get_context("fork").Pool(workers) as pool:
            return list(pool.imap_unordered(fn, spans))
    finally:
        _CTX = prev


def spans_of(m: int, chunk: int):
    return [(lo, min(lo + chunk, m)) for lo in range(0, m, chunk)]


def stripes_of(m: int, parts: int):
    """Split [0, m) into `parts` near-equal contiguous stripes."""
    parts = max(1, min(parts, m)) if m else 1
    edges = [m * i // parts for i in range(parts + 1)]
    return [(lo, hi) for lo, hi in zip(edges, edges[1:]) if hi > lo]
