"""Wrapper of the hand-written CUDA query kernels (csrc/query.cu).

`plquery_kernel` runs `ops.query.plquery_batch` (predict, the prediction
probe, the optional bucket probe, phases A-D), `binsearch_kernel` runs
`ops.query.binsearch_batch` (the bisection's first levels from a table in
shared memory) and `fancy_binsearch_kernel` runs
`ops.query.fancy_binsearch_batch` (the llcp/rlcp-pruned search, a round
one 32-byte node record that `fancy_nodes_kernel` builds once for an
index and its tables, as `ops.query.fancy_nodes` does), one thread a
query, one launch a call and no host sync, with exactly the plain
versions' results. They replace `sapling_tpu/ops/query.py::plquery_batch`
(:1011), `::binsearch_batch` (:1370) and `::fancy_binsearch_batch`
(:1404), XLA programs in the JAX package.

`plquery_cuda`, `binsearch_cuda` and `fancy_binsearch_cuda` take the plain
functions' arguments (without the `take` hook: a kernel cannot run the
index-sharded engine's collective gathers mid-query, so
parallel.sharded_index keeps the plain versions):

  * tensors on the CPU take the plain version (there is no CUDA there);
  * tensors on the card launch a kernel, or raise: there is no fallback.

`stats=True` also has the kernel write each lane's probes and the 32-byte
sectors its reads touched (`LAST_STATS`; the pruned search records the
sectors of its first design's reads there, and the sectors it really
reads as `reads`), and its deepest phase C and
phase D step counts, which it adds to `ops.query.ROUNDS` as the plain
versions' host loops do; that syncs. With `trace=K` it also records the
numbers of the first K sectors each lane touched (int64 [B, K], -1 past
a lane's last), from which a caller counts the distinct sectors of a
call: the bytes its bound is made of. The default call writes nothing
extra. The library is built with nvcc at first use (ops.sw_cuda.
build_kernel, into the gitignored `_build/`); `LAUNCHES` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import query
from .pack import BASES_PER_WORD, P3_BASES
from .sw_cuda import bind_lib, build_kernel

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "query.cu")
PROBES = {"fast3": 0, "prefix64": 1, "packed": 2}   # query.cu's kFast3...

# kernel launches, counted where each kernel is launched
LAUNCHES = {"plquery": 0, "binsearch": 0, "fancy": 0, "fancy_nodes": 0}
# the last stats=True call on the card: int32 [B] probes and sectors a
# lane (and the pruned search's reads), the deepest phase C / phase D step
# counts, and with trace=K the int64 [B, K] sector numbers
LAST_STATS: dict = {}
_LOCK = threading.Lock()
_LIB = None

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SIGNATURES = {
    "plquery_launch": [_P, _LL, _P, _I] + [_P] * 13 + [_LL, _LL, _I, _I, _I]
    + [_LL] * 5 + [_I, _I, _I, _P],
    "binsearch_launch": [_P, _LL, _P, _I] + [_P] * 5 + [_LL, _LL, _I, _I,
                                                         _P],
    "fancy_binsearch_launch": [_P, _LL, _P, _I] + [_P] * 9
    + [_LL, _LL, _I, _I, _I, _P],
    "fancy_nodes_launch": [_P, _LL, _P, _I, _P, _P, _P, _LL, _P],
}


def bind(path: str) -> ctypes.CDLL:
    """The library at `path` with its C entry points typed."""
    return bind_lib(path, SIGNATURES)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(build_kernel(SOURCE))
    return _LIB


def probe_form(length: int, k: int, prefix, prefix3, q3) -> str:
    """The probe plquery_batch takes: fast3 for length <= min(k, 21) with
    prefix3 and q3, prefix64 up to 32 bases, else the packed genome."""
    if prefix3 is not None and q3 is not None and length <= min(k, P3_BASES):
        return "fast3"
    if prefix is not None and length <= 32:
        return "prefix64"
    return "packed"


def _check(name, t, dtypes, shape, device, at_least=False):
    """Refuse what the kernel does not take: another device or dtype, a
    strided tensor, another shape (with at_least, an index array shorter
    than the ranks or buckets the query may read)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the query on {device}")
    fits = t.dim() == len(shape) and all(
        got >= want if at_least else got == want
        for got, want in zip(t.shape, shape))
    if t.dtype not in dtypes or not t.is_contiguous() or not fits:
        raise ValueError(f"{name} must be a contiguous {dtypes[0]} tensor "
                         f"of shape {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")


_I64 = (torch.int64,)
_REV = (torch.int32, torch.int64)


def stats_buffers(b: int, dev, stats: bool, trace: int = 0, rows: int = 2):
    """(lane_stats, depth, trace) buffers of a stats call: int32 [rows, B],
    int32 [2] zeroed, int64 [B, trace] (None without a trace); all None
    without stats."""
    if trace and not stats:
        raise ValueError("trace= needs stats=True")
    if not stats:
        return None, None, None
    return (torch.empty((rows, b), dtype=torch.int32, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev),
            torch.empty((b, trace), dtype=torch.int64, device=dev)
            if trace else None)


def _read_stats(lane, depth, trace) -> None:
    c, d = (int(v) for v in depth.tolist())
    query.ROUNDS["C"] += c
    query.ROUNDS["D"] += d
    LAST_STATS.clear()
    LAST_STATS.update(probes=lane[0], sectors=lane[1], C=c, D=d,
                      trace=trace)
    if lane.shape[0] > 2:
        LAST_STATS["reads"] = lane[2]


def _ptr(t):
    return None if t is None else t.data_ptr()


def plquery_cuda(packed, rev, xlist, ylist, q_words, x, prefix=None,
                 prefix3=None, q3=None, bounds=None, *, n: int, length: int,
                 k: int, buckets: int, most_over: int, most_under: int,
                 max_over: int, max_under: int,
                 max_stride_steps: int = 1 << 20,
                 adaptive_bounds: bool = False, pred64=None,
                 stats: bool = False, trace: int = 0):
    """ops.query.plquery_batch with the same arguments (but `take`) and
    results, on plquery_kernel for tensors on the card (stats, trace: see
    the module's docstring).

    On the card every tensor is contiguous on one device: packed, xlist,
    ylist, prefix, prefix3, q3, x and pred64 int64, rev int32 (uint32
    bits) or int64, bounds int32, q_words int64 [ceil(L/16), B]; pred64
    holds ranks in [0, n). Returns int64 [B] positions, -1 = not found."""
    if x.device.type == "cpu":
        return query.plquery_batch(
            packed, rev, xlist, ylist, q_words, x, prefix, prefix3, q3,
            bounds, n=n, length=length, k=k, buckets=buckets,
            most_over=most_over, most_under=most_under, max_over=max_over,
            max_under=max_under, max_stride_steps=max_stride_steps,
            adaptive_bounds=adaptive_bounds, pred64=pred64)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"plquery_cuda: unsupported device {dev}")
    if adaptive_bounds and bounds is None:
        raise ValueError("adaptive_bounds=True needs the bounds array")
    if length < 1:
        raise ValueError(f"query length {length} < 1")
    b = x.shape[0]
    form = probe_form(length, k, prefix, prefix3, q3)
    if form != "fast3" and q_words is None:
        raise ValueError(f"length {length} at k={k} takes the general "
                         "path, which needs q_words")
    nb = 1 << buckets
    _check("x", x, _I64, (b,), dev)
    _check("xlist", xlist, _I64, (nb + 1,), dev, at_least=True)
    _check("ylist", ylist, _I64, (nb + 1,), dev, at_least=True)
    _check("rev", rev, _REV, (n,), dev, at_least=True)
    if adaptive_bounds:
        _check("bounds", bounds, (torch.int32,), (nb,), dev, at_least=True)
    if pred64 is not None:
        _check("pred64", pred64, _I64, (b,), dev)
    if form == "fast3":
        _check("prefix3", prefix3, _I64, (n,), dev, at_least=True)
        _check("q3", q3, _I64, (b,), dev)
    else:
        wq = -(-length // BASES_PER_WORD)
        _check("q_words", q_words, _I64, (wq, b), dev)
        if form == "prefix64":
            _check("prefix", prefix, _I64, (n,), dev, at_least=True)
        else:
            # the kernel clamps word indexes to the array, as probe_at does
            _check("packed", packed, _I64, (1,), dev, at_least=True)
    out = torch.empty(b, dtype=torch.int64, device=dev)
    lane, depth, tr = stats_buffers(b, dev, stats, trace)
    if b:
        with torch.cuda.device(dev):
            rc = launch_plquery(
                _lib(), torch.cuda.current_stream(dev).cuda_stream, packed,
                rev, xlist, ylist, q_words, x, prefix, prefix3, q3, bounds,
                pred64, out, lane, depth, tr, n=n, length=length, k=k,
                buckets=buckets, most_over=most_over, most_under=most_under,
                max_over=max_over, max_under=max_under,
                max_stride_steps=max_stride_steps,
                adaptive_bounds=adaptive_bounds, form=form)
        if rc != 0:
            raise RuntimeError(f"plquery kernel launch failed: cudaError {rc}")
        with _LOCK:
            LAUNCHES["plquery"] += 1
    if stats:
        _read_stats(lane, depth, tr)
    return out


def launch_plquery(lib, stream, packed, rev, xlist, ylist, q_words, x,
                   prefix, prefix3, q3, bounds, pred64, out, lane, depth,
                   trace, *,
                   n: int, length: int, k: int, buckets: int, most_over: int,
                   most_under: int, max_over: int, max_under: int,
                   max_stride_steps: int, adaptive_bounds: bool,
                   form: str) -> int:
    """plquery_launch of `lib` on checked tensors (None for an unused
    one), on `stream`; returns its cudaError_t."""
    return lib.plquery_launch(
        _ptr(packed), 0 if packed is None else packed.shape[0],
        rev.data_ptr(), int(rev.dtype == torch.int64), xlist.data_ptr(),
        ylist.data_ptr(), _ptr(prefix), _ptr(prefix3),
        _ptr(bounds) if adaptive_bounds else None, _ptr(q_words), _ptr(q3),
        x.data_ptr(), _ptr(pred64), out.data_ptr(), _ptr(lane), _ptr(depth),
        _ptr(trace), x.shape[0], n, length, k, buckets, most_over,
        most_under, max_over, max_under, max_stride_steps,
        int(adaptive_bounds), 0 if trace is None else trace.shape[1],
        PROBES[form], stream)


def launch_binsearch(lib, stream, packed, rev, q_words, out, lane, depth,
                     trace, *, n: int, length: int) -> int:
    """binsearch_launch of `lib` on checked tensors, on `stream`; returns
    its cudaError_t."""
    return lib.binsearch_launch(
        packed.data_ptr(), packed.shape[0], rev.data_ptr(),
        int(rev.dtype == torch.int64), q_words.data_ptr(), out.data_ptr(),
        _ptr(lane), _ptr(depth), _ptr(trace), q_words.shape[1], n, length,
        0 if trace is None else trace.shape[1], stream)


def binsearch_cuda(packed, rev, q_words, *, n: int, length: int,
                   stats: bool = False, trace: int = 0):
    """ops.query.binsearch_batch with the same arguments (but `take`) and
    results, on binsearch_kernel for tensors on the card: packed int64,
    rev int32 (uint32 bits) or int64, q_words int64 [ceil(L/16), B], all
    contiguous on one device. Returns int64 [B] positions, -1 = not
    found."""
    if q_words.device.type == "cpu":
        return query.binsearch_batch(packed, rev, q_words, n=n,
                                     length=length)
    dev = q_words.device
    if dev.type != "cuda":
        raise ValueError(f"binsearch_cuda: unsupported device {dev}")
    if length < 1:
        raise ValueError(f"query length {length} < 1")
    b = q_words.shape[1]
    _check("q_words", q_words, _I64, (-(-length // BASES_PER_WORD), b), dev)
    _check("packed", packed, _I64, (1,), dev, at_least=True)
    _check("rev", rev, _REV, (n,), dev, at_least=True)
    out = torch.empty(b, dtype=torch.int64, device=dev)
    lane, depth, tr = stats_buffers(b, dev, stats, trace)
    if b:
        with torch.cuda.device(dev):
            rc = launch_binsearch(
                _lib(), torch.cuda.current_stream(dev).cuda_stream, packed,
                rev, q_words, out, lane, depth, tr, n=n, length=length)
        if rc != 0:
            raise RuntimeError(
                f"binsearch kernel launch failed: cudaError {rc}")
        with _LOCK:
            LAUNCHES["binsearch"] += 1
    if stats:
        _read_stats(lane, depth, tr)
    return out


def launch_fancy(lib, stream, packed, rev, llcp, rlcp, prefix, nodes,
                 q_words, out, lane, depth, trace, *, n: int, length: int,
                 form: str) -> int:
    """fancy_binsearch_launch of `lib` on checked tensors, on `stream`;
    returns its cudaError_t. The kernel's 32-base compare of the node
    records answers every probe up to 32 bases (its prefix64
    instantiation); `form` decides only whether prefix is passed, so that
    the trace records the sectors that form's probe read."""
    return lib.fancy_binsearch_launch(
        packed.data_ptr(), packed.shape[0], rev.data_ptr(),
        int(rev.dtype == torch.int64), llcp.data_ptr(), rlcp.data_ptr(),
        _ptr(prefix) if form == "prefix64" else None, nodes.data_ptr(),
        q_words.data_ptr(), out.data_ptr(), _ptr(lane), _ptr(depth),
        _ptr(trace), q_words.shape[1], n, length,
        0 if trace is None else trace.shape[1],
        PROBES["prefix64" if length <= 32 else "packed"], stream)


def launch_fancy_nodes(lib, stream, packed, rev, llcp, rlcp, nodes, *,
                       n: int) -> int:
    """fancy_nodes_launch of `lib` on checked tensors, on `stream`; returns
    its cudaError_t."""
    return lib.fancy_nodes_launch(
        packed.data_ptr(), packed.shape[0], rev.data_ptr(),
        int(rev.dtype == torch.int64), llcp.data_ptr(), rlcp.data_ptr(),
        nodes.data_ptr(), n, stream)


def _check_tables(packed, rev, llcp, rlcp, n: int, dev) -> None:
    if not 1 <= n < 1 << 31:
        raise ValueError(f"the pruned search needs 1 <= n < 2^31, got {n}")
    _check("packed", packed, _I64, (1,), dev, at_least=True)
    _check("rev", rev, _REV, (n,), dev, at_least=True)
    _check("llcp", llcp, (torch.int32,), (n,), dev, at_least=True)
    _check("rlcp", rlcp, (torch.int32,), (n,), dev, at_least=True)


def fancy_nodes_cuda(packed, rev, llcp, rlcp, *, n: int):
    """ops.query.fancy_nodes (the pruned search's int64 [n, 4] node
    records) on fancy_nodes_kernel for tensors on the card, with the
    arguments fancy_binsearch_cuda takes; tensors on the CPU take the
    plain version."""
    dev = packed.device
    if dev.type == "cpu":
        return query.fancy_nodes(packed, rev, llcp, rlcp, n=n)
    if dev.type != "cuda":
        raise ValueError(f"fancy_nodes_cuda: unsupported device {dev}")
    _check_tables(packed, rev, llcp, rlcp, n, dev)
    nodes = torch.empty((n, 4), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = launch_fancy_nodes(
            _lib(), torch.cuda.current_stream(dev).cuda_stream, packed, rev,
            llcp, rlcp, nodes, n=n)
    if rc != 0:
        raise RuntimeError(f"fancy nodes kernel launch failed: cudaError {rc}")
    with _LOCK:
        LAUNCHES["fancy_nodes"] += 1
    return nodes


def fancy_binsearch_cuda(packed, rev, llcp, rlcp, q_words, *, n: int,
                         length: int, prefix=None, nodes=None,
                         stats: bool = False, trace: int = 0):
    """ops.query.fancy_binsearch_batch with the same arguments and results,
    on fancy_binsearch_kernel for tensors on the card: packed int64, rev
    int32 (uint32 bits) or int64, llcp / rlcp int32 [n], prefix int64 or
    None (its probe answers at length <= 32), q_words int64 [ceil(L/16),
    B], all contiguous on one device; n < 2^31 (the lane state is 32-bit).
    `nodes` are the node records fancy_nodes_cuda made of the same packed,
    rev, llcp and rlcp; a call without them on the card makes them first
    (one more launch), so a caller that searches more than once passes
    them. On the CPU they are not read: the plain version reads the
    tables. The kernel adds no rounds (the plain version has none), and
    with stats LAST_STATS["reads"] holds the sectors a lane really read.
    Returns int64 [B] positions, -1 = not found."""
    if q_words.device.type == "cpu":
        return query.fancy_binsearch_batch(packed, rev, llcp, rlcp, q_words,
                                           n=n, length=length, prefix=prefix)
    dev = q_words.device
    if dev.type != "cuda":
        raise ValueError(f"fancy_binsearch_cuda: unsupported device {dev}")
    if length < 1:
        raise ValueError(f"query length {length} < 1")
    _check_tables(packed, rev, llcp, rlcp, n, dev)
    b = q_words.shape[1]
    form = "prefix64" if prefix is not None and length <= 32 else "packed"
    _check("q_words", q_words, _I64, (-(-length // BASES_PER_WORD), b), dev)
    if form == "prefix64":
        _check("prefix", prefix, _I64, (n,), dev, at_least=True)
    if nodes is None:
        nodes = fancy_nodes_cuda(packed, rev, llcp, rlcp, n=n)
    _check("nodes", nodes, _I64, (n, 4), dev)
    if nodes.data_ptr() % 32:
        raise ValueError("nodes must start on a 32-byte boundary")
    out = torch.empty(b, dtype=torch.int64, device=dev)
    lane, depth, tr = stats_buffers(b, dev, stats, trace, rows=3)
    if b:
        with torch.cuda.device(dev):
            rc = launch_fancy(
                _lib(), torch.cuda.current_stream(dev).cuda_stream, packed,
                rev, llcp, rlcp, prefix, nodes, q_words, out, lane, depth,
                tr, n=n, length=length, form=form)
        if rc != 0:
            raise RuntimeError(
                f"fancy binsearch kernel launch failed: cudaError {rc}")
        with _LOCK:
            LAUNCHES["fancy"] += 1
    if stats:
        _read_stats(lane, depth, tr)
    return out
