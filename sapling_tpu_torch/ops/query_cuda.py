"""Wrapper of the hand-written CUDA query kernels (csrc/query.cu).

`plquery_kernel` runs `ops.query.plquery_batch` (predict, the prediction
probe, the optional bucket probe, phases A-D; a prediction one 32-byte
bucket record of `bucket_records_kernel`, a probe one 8-byte prefix3 word
where the caller passes q3 (fast3), else one 16-byte rank record of
`records_kernel` where rev and the genome outgrow the card's L2
(reads_rank_records), else rev and the genome; tables made once for an
index, as `ops.query.bucket_records` and `plquery_records` make them; on
rank records under windows of 16 W ranks or more and up to 32 bases, its
sampled form (kSampledKey) first asks a sample of the records' keys,
one every W ranks (`ops.query.rank_sample`, W from the card's L2:
sample_shift), and read a record only where the sample cannot decide
the probe: the same path),
`binsearch_kernel` runs
`ops.query.binsearch_batch` (the bisection's first levels from a table in
shared memory) and `fancy_binsearch_kernel` runs
`ops.query.fancy_binsearch_batch` (the llcp/rlcp-pruned search, a round
one 32-byte node record built once for an index and its tables, as
`ops.query.fancy_nodes` builds them), one thread a query, one launch a
call and no host sync, with exactly the plain versions' results. Both
record tables of one index come from `records_kernel`, which reads the
genome as 32-bit words (genome32). They replace
`sapling_tpu/ops/query.py::plquery_batch` (:1011), `::binsearch_batch`
(:1370) and `::fancy_binsearch_batch` (:1404), XLA programs in the JAX
package.

`plquery_cuda`, `binsearch_cuda` and `fancy_binsearch_cuda` take the plain
functions' arguments (without the `take` hook: a kernel cannot run the
index-sharded engine's collective gathers mid-query, so
parallel.sharded_index keeps the plain versions):

  * tensors on the CPU take the plain version (there is no CUDA there);
  * tensors on the card launch a kernel, or raise: there is no fallback.

`PlqueryPlan` is plquery_cuda's call cut in two for a caller that queries
one index many times (SaplingIndex.query_device, NNQueryEngine): the
index's arrays checked and laid out for the kernel once, then a request
that checks only its own tensors and launches with a few arguments; a plan
made without bucket records takes each request's predicted ranks (pred64).
`PLANS` counts the plans made and the requests launched from one.

`stats=True` also has the kernel write six counts a lane (`LAST_STATS`,
each int32 [B]; a kernel without the phase writes 0):

  * `probes`;
  * `sectors`, the 32-byte sectors its reads touched (the rank sample's
    among them);
  * `c_steps`, its phase C (stride) steps;
  * `d_steps`, its phase D (bisection) steps;
  * `genome_sectors`, those of its sectors that lie in the packed genome;
  * `sample_decided`, its probes the rank sample decided without a record
    read (0 but in plquery_kernel's sampled form);

and its deepest phase C and phase D step counts (`C`, `D`), which it adds
to `ops.query.ROUNDS` as the plain versions' host loops do; that syncs.
The kernel's lane_stats rows 0-5 hold them in this order; a stats call
launches the kernel's instance that counts the genome's sectors and the
sample's decisions, so that the one a call without stats launches pays
no register for them. With `trace=K` it also records the numbers of the
first K sectors each lane touched (int64 [B, K], -1 past a lane's last),
from which a caller counts the distinct sectors of a call: the bytes its
bound is made of. The default call writes nothing extra. The library is built with nvcc at first use (ops.sw_cuda.
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
PROBES = {"prefix64": 1, "packed": 2}   # query.cu's kPrefix64, kPacked

# kernel launches, counted where each kernel is launched
LAUNCHES = {"plquery": 0, "binsearch": 0, "fancy": 0, "fancy_nodes": 0,
            "bucket_records": 0, "plquery_records": 0}
# the last stats=True call on the card: int32 [B] counts a lane (STAT_ROWS,
# the kernel's lane_stats rows in order), the deepest phase C / phase D
# step counts, and with trace=K the int64 [B, K] sector numbers
LAST_STATS: dict = {}
# launch plans made (PlqueryPlan) and requests launched from one
PLANS = {"made": 0, "served": 0}
STAT_ROWS = ("probes", "sectors", "c_steps", "d_steps", "genome_sectors",
             "sample_decided")
# the 'most' window, in W's, from which a plan on rank records asks the
# rank sample (samples_probes)
SAMPLE_WINDOWS = 16
_LOCK = threading.Lock()
_LIB = None

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SIGNATURES = {
    "plquery_launch": [_P, _LL, _P, _I] + [_P] * 7 + [_I] + [_P] * 8
    + [_LL, _LL, _I, _I, _I] + [_LL] * 5 + [_I, _I, _P],
    "binsearch_launch": [_P, _LL, _P, _I] + [_P] * 5 + [_LL, _LL, _I, _I,
                                                         _P],
    "fancy_binsearch_launch": [_P, _LL] + [_P] * 6
    + [_LL, _LL, _I, _I, _I, _P],
    "records_launch": [_P, _LL, _P, _I, _P, _P, _P, _P, _LL, _P],
    "bucket_records_launch": [_P, _P, _P, _P, _I, _P],
    "plquery_plan_make": [_P, _P, _LL, _P, _I] + [_P] * 7 + [_I]
    + [_LL, _I, _I] + [_LL] * 5 + [_I],
    "plquery_plan_launch": [_P] * 6 + [_LL, _I, _P],
    "plquery_plan_size": [],
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
    prefix3 and q3 (plquery_kernel too), prefix64 up to 32 bases, else the
    packed genome."""
    if prefix3 is not None and q3 is not None and length <= min(k, P3_BASES):
        return "fast3"
    if prefix is not None and length <= 32:
        return "prefix64"
    return "packed"


def kernel_form(length: int, k: int, prefix3, q3, rank_recs) -> str:
    """The probe plquery_kernel takes: fast3 where plquery_batch takes it
    (probe_form), else the rank records' 32-base key up to 32 bases
    ("key"), past 32 the key and on a tie the genome ("records"), without
    rank records rev and the genome ("packed")."""
    if probe_form(length, k, None, prefix3, q3) == "fast3":
        return "fast3"
    if rank_recs is None:
        return "packed"
    return "key" if length <= 32 else "records"


def l2_bytes(device) -> int:
    """The L2 cache of the card `device`, in bytes."""
    return torch.cuda.get_device_properties(device).L2_cache_size


def reads_rank_records(rev, packed) -> bool:
    """Whether plquery on the card reads rank records for these arrays:
    where rev and the packed genome outgrow the card's L2, so that a probe
    reading them would wait on device memory twice (46 Mbp on an H100:
    1.05-1.26x faster on the records); where they fit (4.6 Mbp: 0.83-1.00x)
    a probe finds both in L2."""
    return (rev.numel() * rev.element_size()
            + packed.numel() * packed.element_size()) > l2_bytes(rev.device)


def sample_shift(n: int, l2: int) -> int:
    """log2 of W, the ranks between two entries of the rank sample
    (ops.query.rank_sample) of an index of n ranks on a card of `l2` bytes
    of L2: the smallest power of two whose sample, 8 bytes an entry, takes
    at most a quarter of the L2, so that it stays there beside the records
    a request streams through (100 Mbp on an H100: W = 64, 12.5 MB)."""
    shift = 0
    while 8 * (((n - 1) >> shift) + 2) > l2 // 4:
        shift += 1
    return shift


def samples_probes(most_over: int, most_under: int, shift: int) -> bool:
    """Whether plquery on rank records with a rank sample of 2^shift ranks
    an entry takes plquery_kernel's sampled form (up to 32 bases; past
    them the records form): where the 'most' window spans SAMPLE_WINDOWS
    W or more, so that most of a lane's probes bisect intervals many
    brackets wide, which the sample decides (the NN engine's windows);
    under narrower windows (the PWL table's: a few dozen ranks) a probe
    would read the sample and then its record."""
    return most_over + most_under >= SAMPLE_WINDOWS << shift


def copies_rank_records(packed) -> bool:
    """Whether node records on the card copy their first halves from the
    index's rank records, where it holds them (fancy_nodes_cuda's
    rank_recs): where the builders' 32-bit genome (4 bytes a word of
    `packed`) outgrows the card's L2, so that its gathers miss (230 Mbp on
    an H100: the copy 1.90x faster); where it fits (46 Mbp) the gather ran
    1.02-1.03x faster than the copy."""
    return 4 * packed.shape[0] > l2_bytes(packed.device)


def _check(name, t, dtypes, shape, device, at_least=False):
    """Refuse what the kernel does not take: another device or dtype, a
    strided tensor, another shape (with at_least, an index array shorter
    than the ranks or buckets the query may read)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the query on {device}")
    fits = (t.dim() == len(shape) and all(
        got >= want for got, want in zip(t.shape, shape))) if at_least else (
        t.shape == shape)
    if t.dtype not in dtypes or not t.is_contiguous() or not fits:
        raise ValueError(f"{name} must be a contiguous {dtypes[0]} tensor "
                         f"of shape {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")


_I64 = (torch.int64,)
_REV = (torch.int32, torch.int64)


def stats_buffers(b: int, dev, stats: bool, trace: int = 0):
    """(lane_stats, depth, trace) buffers of a stats call: int32
    [len(STAT_ROWS), B], int32 [2] zeroed, int64 [B, trace] (None without a
    trace); all None without stats."""
    if trace and not stats:
        raise ValueError("trace= needs stats=True")
    if not stats:
        return None, None, None
    return (torch.empty((len(STAT_ROWS), b), dtype=torch.int32, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev),
            torch.empty((b, trace), dtype=torch.int64, device=dev)
            if trace else None)


def _read_stats(lane, depth, trace) -> None:
    c, d = (int(v) for v in depth.tolist())
    query.ROUNDS["C"] += c
    query.ROUNDS["D"] += d
    LAST_STATS.clear()
    LAST_STATS.update(zip(STAT_ROWS, lane), C=c, D=d, trace=trace)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(name, t, to: int) -> None:
    if t.data_ptr() % to:
        raise ValueError(f"{name} must start on a {to}-byte boundary")


def _check_request(x, q_words, q3, dev, *, length: int, k: int,
                   fast3: bool) -> int:
    """plquery_cuda's checks of a request's own tensors (x; q3 on the
    fast3 probe, else q_words for `length`); returns B."""
    if length < 1:
        raise ValueError(f"query length {length} < 1")
    if not fast3 and q_words is None:
        raise ValueError(f"length {length} at k={k} takes the general "
                         "path, which needs q_words")
    b = x.shape[0]
    _check("x", x, _I64, (b,), dev)
    if fast3:
        _check("q3", q3, _I64, (b,), dev)
    else:
        _check("q_words", q_words, _I64, (-(-length // BASES_PER_WORD), b),
               dev)
    return b


def _check_index(dev, xlist, ylist, rev, packed, prefix3, bounds,
                 bucket_recs, rank_recs, *, n: int, buckets: int,
                 rank_sample=None, shift: int = 0) -> None:
    """plquery_cuda's checks of an index's arrays, each of packed,
    prefix3, bounds, the record tables and the rank sample (of 2^shift
    ranks an entry, read with rank records) where it is given (not
    None)."""
    nb = 1 << buckets
    _check("xlist", xlist, _I64, (nb + 1,), dev, at_least=True)
    _check("ylist", ylist, _I64, (nb + 1,), dev, at_least=True)
    _check("rev", rev, _REV, (n,), dev, at_least=True)
    if prefix3 is not None:
        _check("prefix3", prefix3, _I64, (n,), dev, at_least=True)
    if packed is not None:
        # the kernel clamps word indexes to the array, as probe_at does
        _check("packed", packed, _I64, (1,), dev, at_least=True)
    if rank_recs is not None:
        _check("rank_recs", rank_recs, _I64, (n, 2), dev)
        _aligned("rank_recs", rank_recs, 16)
    if rank_sample is not None:
        _check("rank_sample", rank_sample, _I64, (((n - 1) >> shift) + 2,),
               dev)
    if bounds is not None:
        _check("bounds", bounds, (torch.int32,), (nb,), dev, at_least=True)
    if bucket_recs is not None:
        _check("bucket_recs", bucket_recs, _I64, (nb, 4), dev)
        _aligned("bucket_recs", bucket_recs, 32)


def _launched(name: str, rc: int, planned: bool = False) -> None:
    """Raise unless a launch returned cudaSuccess; count it (and, where
    it was launched from a plan, count it served)."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    with _LOCK:
        LAUNCHES[name] += 1
        PLANS["served"] += planned


def bucket_records_cuda(xlist, ylist, bounds=None, *, buckets: int):
    """ops.query.bucket_records (plquery's int64 [2^buckets, 4] bucket
    records, a prediction's one 32-byte load) on bucket_records_kernel for
    tensors on the card: xlist and ylist int64 [2^buckets + 1], bounds
    int32 [2^buckets] or None; tensors on the CPU take the plain version."""
    dev = xlist.device
    if dev.type == "cpu":
        return query.bucket_records(xlist, ylist, bounds, buckets=buckets)
    if dev.type != "cuda":
        raise ValueError(f"bucket_records_cuda: unsupported device {dev}")
    nb = 1 << buckets
    _check("xlist", xlist, _I64, (nb + 1,), dev, at_least=True)
    _check("ylist", ylist, _I64, (nb + 1,), dev, at_least=True)
    if bounds is not None:
        _check("bounds", bounds, (torch.int32,), (nb,), dev, at_least=True)
    recs = torch.empty((nb, 4), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = launch_bucket_records(
            _lib(), torch.cuda.current_stream(dev).cuda_stream, xlist, ylist,
            bounds, recs, buckets=buckets)
    _launched("bucket_records", rc)
    return recs


def genome32(packed):
    """The packed genome as the record builders read it on the card: int32
    words holding the uint32 words' bits. int32 words are taken as they
    are; int64 words (device_arrays' form, values < 2^32) are narrowed to
    their low 32 bits on their device (one elementwise pass, freed with
    the result)."""
    return packed if packed.dtype == torch.int32 else packed.to(torch.int32)


def _records(name, packed, rev, llcp, rlcp, n: int, rank_recs=None):
    """The records kernel's table `name` on the card: rank records (llcp
    None) or node records, of the genome's words (int64 or int32:
    genome32), rev and the tables (node records copy their first halves
    from rank_recs where it is given), all contiguous on one device."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _check("packed", packed, (torch.int64, torch.int32), (1,), dev,
           at_least=True)
    if rank_recs is not None:
        _check("rank_recs", rank_recs, _I64, (n, 2), dev)
        _aligned("rank_recs", rank_recs, 16)
    words = genome32(packed) if rank_recs is None else packed
    recs = torch.empty((n, 2 if llcp is None else 4), dtype=torch.int64,
                       device=dev)
    with torch.cuda.device(dev):
        rc = launch_records(
            _lib(), torch.cuda.current_stream(dev).cuda_stream, words, rev,
            llcp, rlcp, recs, n=n, rank_recs=rank_recs)
    _launched(name, rc)
    return recs


def plquery_records_cuda(packed, rev, *, n: int):
    """ops.query.plquery_records (plquery's int64 [n, 2] rank records, a
    probe's one 16-byte load) on records_kernel for tensors on the card:
    packed the genome's words (int64, or their 32-bit form, genome32),
    rev int32 (uint32 bits) or int64 [n]; tensors on the CPU take the
    plain version (int64 words)."""
    if packed.device.type == "cpu":
        return query.plquery_records(packed, rev, n=n)
    _check("rev", rev, _REV, (n,), packed.device, at_least=True)
    return _records("plquery_records", packed, rev, None, None, n)


def launch_bucket_records(lib, stream, xlist, ylist, bounds, recs, *,
                          buckets: int) -> int:
    """bucket_records_launch of `lib` on checked tensors, on `stream`;
    returns its cudaError_t."""
    return lib.bucket_records_launch(xlist.data_ptr(), ylist.data_ptr(),
                                     _ptr(bounds), recs.data_ptr(), buckets,
                                     stream)


def launch_records(lib, stream, words, rev, llcp, rlcp, recs, *, n: int,
                   rank_recs=None) -> int:
    """records_launch of `lib` on checked tensors (words: genome32's;
    llcp and rlcp None for rank records; rank_recs, for node records, the
    rank records they copy from, or None), on `stream`; returns its
    cudaError_t."""
    return lib.records_launch(
        words.data_ptr(), words.shape[0], rev.data_ptr(),
        int(rev.dtype == torch.int64), _ptr(llcp), _ptr(rlcp),
        _ptr(rank_recs), recs.data_ptr(), n, stream)


def plquery_cuda(packed, rev, xlist, ylist, q_words, x, prefix=None,
                 prefix3=None, q3=None, bounds=None, *, n: int, length: int,
                 k: int, buckets: int, most_over: int, most_under: int,
                 max_over: int, max_under: int,
                 max_stride_steps: int = 1 << 20,
                 adaptive_bounds: bool = False, pred64=None,
                 bucket_recs=None, rank_recs=None, rank_sample=None,
                 sample_shift: int = 0, stats: bool = False, trace: int = 0):
    """ops.query.plquery_batch with the same arguments (but `take`) and
    results, on plquery_kernel for tensors on the card (stats, trace: see
    the module's docstring).

    On the card every tensor is contiguous on one device: packed, xlist,
    ylist, prefix3, q3, x and pred64 int64, rev int32 (uint32 bits) or
    int64, bounds int32, q_words int64 [ceil(L/16), B]; pred64 holds ranks
    in [0, n); prefix is not read. The probe is the caller's choice
    (kernel_form): fast3 where it passes q3 and prefix3 (as plquery_batch
    takes it; faster under deep cascades such as the NN engine's), else
    rank records or rev and the genome. `bucket_recs` are the bucket
    records bucket_records_cuda made of the same xlist, ylist and bounds
    (read without pred64), `rank_recs` the rank records
    plquery_records_cuda made of the same packed and rev; a call on the
    card without bucket records makes them first (one more launch), and
    without rank records makes them where reads_rank_records says the
    kernel reads them (one more), so a caller that queries more than once
    passes them (SaplingIndex.query_records). Rank records passed are read
    whatever the arrays' size. `rank_sample` is ops.query.rank_sample of
    those rank records at `sample_shift` (SaplingIndex.rank_sample), read
    where samples_probes says so for these windows. On the CPU none is
    read: the plain version reads the arrays. Returns int64 [B] positions,
    -1 = not found."""
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
    fast3 = probe_form(length, k, prefix, prefix3, q3) == "fast3"
    b = _check_request(x, q_words, q3, dev, length=length, k=k, fast3=fast3)
    if fast3:
        rank_recs = None
    else:
        q3 = None
    if pred64 is not None:
        _check("pred64", pred64, _I64, (b,), dev)
    elif bucket_recs is None:
        bucket_recs = bucket_records_cuda(xlist, ylist, bounds,
                                          buckets=buckets)
    if (fast3 or rank_recs is None
            or not samples_probes(most_over, most_under, sample_shift)):
        rank_sample = None
    _check_index(dev, xlist, ylist, rev, None if fast3 else packed,
                 prefix3 if fast3 else None,
                 bounds if adaptive_bounds else None,
                 None if pred64 is not None else bucket_recs, rank_recs,
                 n=n, buckets=buckets, rank_sample=rank_sample,
                 shift=sample_shift)
    if not fast3 and rank_recs is None and reads_rank_records(rev, packed):
        rank_recs = plquery_records_cuda(packed, rev, n=n)
    out = torch.empty(b, dtype=torch.int64, device=dev)
    lane, depth, tr = stats_buffers(b, dev, stats, trace)
    if b:
        with torch.cuda.device(dev):
            rc = launch_plquery(
                _lib(), torch.cuda.current_stream(dev).cuda_stream, packed,
                rev, xlist, ylist, q_words, x, prefix3, q3, bounds, pred64,
                out, lane, depth, tr, n=n, length=length, k=k,
                buckets=buckets,
                most_over=most_over, most_under=most_under,
                max_over=max_over, max_under=max_under,
                max_stride_steps=max_stride_steps,
                adaptive_bounds=adaptive_bounds, bucket_recs=bucket_recs,
                rank_recs=rank_recs, rank_sample=rank_sample,
                sample_shift=sample_shift)
        _launched("plquery", rc)
    if stats:
        _read_stats(lane, depth, tr)
    return out


def launch_plquery(lib, stream, packed, rev, xlist, ylist, q_words, x,
                   prefix3, q3, bounds, pred64, out, lane, depth, trace, *,
                   n: int, length: int, k: int, buckets: int, most_over: int,
                   most_under: int, max_over: int, max_under: int,
                   max_stride_steps: int, adaptive_bounds: bool,
                   bucket_recs=None, rank_recs=None, rank_sample=None,
                   sample_shift: int = 0) -> int:
    """plquery_launch of `lib` on checked tensors (None for an unused
    one; q3 only where the fast3 probe answers), on `stream`; returns its
    cudaError_t. The kernel takes its probe from q3, rank_recs and the
    length (kernel_form), and on rank records asks rank_sample, of
    2^sample_shift ranks an entry, where it is given."""
    return lib.plquery_launch(
        _ptr(packed), 0 if packed is None else packed.shape[0],
        rev.data_ptr(), int(rev.dtype == torch.int64), xlist.data_ptr(),
        ylist.data_ptr(), _ptr(prefix3),
        _ptr(bounds) if adaptive_bounds else None, _ptr(bucket_recs),
        _ptr(rank_recs), _ptr(rank_sample), sample_shift, _ptr(q_words),
        _ptr(q3), x.data_ptr(),
        _ptr(pred64), out.data_ptr(), _ptr(lane), _ptr(depth), _ptr(trace),
        x.shape[0], n,
        length, k, buckets, most_over, most_under, max_over, max_under,
        max_stride_steps, int(adaptive_bounds),
        0 if trace is None else trace.shape[1], stream)


class PlqueryPlan:
    """plquery_cuda's calls on one index's arrays and configuration cut in
    two, for a caller that queries the index many times: the plan is made
    once, with every check plquery_cuda makes of those arrays
    (_check_index; bucket_recs, rank_recs and prefix3 where given), and
    laid out for the kernel by the library's plquery_plan_make. A request
    (`__call__`) then makes plquery_cuda's checks of its own tensors
    (_check_request, and pred64's), allocates its output and launches with
    nine arguments (plquery_plan_launch), which picks the kernel's probe
    as plquery_launch does: plquery_cuda's results. A plan comes in two
    forms: with bucket records it predicts from the PWL table
    (SaplingIndex.query_device); without them every request passes its
    predicted ranks as pred64, as plquery_cuda's pred64 call takes them
    (NNQueryEngine). Without stats or trace: those calls take
    plquery_cuda. On rank records with a rank sample (rank_sample, of
    2^sample_shift ranks an entry) a plan whose 'most' window is wide
    enough (samples_probes) launches plquery_kernel's sampled form up to
    32 bases (`sampled`). The plan keeps the arrays it was made of alive and reads
    them as they are: a caller whose arrays change makes a new plan
    (SaplingIndex.query_records). `lib`: the query library (default: this
    module's, built on first use)."""

    def __init__(self, packed, rev, xlist, ylist, prefix3, bounds, *,
                 n: int, k: int, buckets: int, most_over: int,
                 most_under: int, max_over: int, max_under: int,
                 max_stride_steps: int = 1 << 20,
                 adaptive_bounds: bool = False, bucket_recs, rank_recs,
                 rank_sample=None, sample_shift: int = 0, lib=None):
        dev = rev.device
        if adaptive_bounds and bounds is None:
            raise ValueError("adaptive_bounds=True needs the bounds array")
        bounds = bounds if adaptive_bounds else None
        if rank_recs is None or not samples_probes(most_over, most_under,
                                                   sample_shift):
            rank_sample = None
        _check_index(dev, xlist, ylist, rev, packed, prefix3, bounds,
                     bucket_recs, rank_recs, n=n, buckets=buckets,
                     rank_sample=rank_sample, shift=sample_shift)
        lib = lib or _lib()
        self._plan = ctypes.create_string_buffer(lib.plquery_plan_size())
        lib.plquery_plan_make(
            self._plan, packed.data_ptr(), packed.shape[0], rev.data_ptr(),
            int(rev.dtype == torch.int64), xlist.data_ptr(),
            ylist.data_ptr(), _ptr(prefix3), _ptr(bounds),
            _ptr(bucket_recs), _ptr(rank_recs), _ptr(rank_sample),
            sample_shift, n, k, buckets, most_over, most_under, max_over,
            max_under, max_stride_steps, int(adaptive_bounds))
        self._launch = lib.plquery_plan_launch
        # what the kernel reads through the plan
        self._arrays = (packed, rev, xlist, ylist, prefix3, bounds,
                        bucket_recs, rank_recs)
        # the rank sample, where the plan's requests on rank records take
        # the sampled instance (fast3 requests read prefix3)
        self._sample = rank_sample
        self.sampled = rank_sample is not None
        self.device, self.k, self.prefix3 = dev, k, prefix3
        # the form: each request's predicted ranks in place of the table's
        self.takes_pred64 = bucket_recs is None
        with _LOCK:
            PLANS["made"] += 1

    def launch(self, stream, x, q_words, q3, out, length: int,
               pred64=None) -> int:
        """plquery_plan_launch of the plan on checked tensors (q3 only
        where the fast3 probe answers, pred64 only on a plan that takes
        it), on `stream`; returns its cudaError_t."""
        return self._launch(self._plan, x.data_ptr(), _ptr(q_words),
                            _ptr(q3), _ptr(pred64), out.data_ptr(),
                            x.shape[0], length, stream)

    def __call__(self, x, q_words, q3, length: int, pred64=None):
        """A request: plquery_cuda on the plan's arrays for x (int64 [B]),
        q_words (int64 [ceil(L/16), B]), q3 (int64 [B], read where the
        fast3 probe answers: probe_form) and, on a plan without bucket
        records, pred64 (int64 [B] ranks in [0, n)) on the plan's device,
        each checked as plquery_cuda checks it. Returns int64 [B]
        positions, -1 = not found, in a new tensor."""
        dev = self.device
        fast3 = probe_form(length, self.k, None, self.prefix3, q3) == "fast3"
        b = _check_request(x, q_words, q3, dev, length=length, k=self.k,
                           fast3=fast3)
        if self.takes_pred64:
            if pred64 is None:
                raise ValueError("a plan without bucket records takes the "
                                 "request's pred64")
            _check("pred64", pred64, _I64, (b,), dev)
        elif pred64 is not None:
            raise ValueError("a plan with bucket records predicts from its "
                             "table: pred64 takes a plan without them")
        out = x.new_empty(b)
        if b:
            q3 = q3 if fast3 else None
            # torch.cuda.current_stream(dev).cuda_stream without the Stream
            # object it makes (3.9 us a call on the H100's host, PERF.md §6)
            stream = torch._C._cuda_getCurrentRawStream(dev.index)
            if torch.cuda.current_device() == dev.index:
                rc = self.launch(stream, x, q_words, q3, out, length, pred64)
            else:
                with torch.cuda.device(dev):
                    rc = self.launch(stream, x, q_words, q3, out, length,
                                     pred64)
            _launched("plquery", rc, planned=True)
        return out


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
        _launched("binsearch", rc)
    if stats:
        _read_stats(lane, depth, tr)
    return out


def launch_fancy(lib, stream, packed, nodes, q_words, out, lane, depth,
                 trace, *, n: int, length: int) -> int:
    """fancy_binsearch_launch of `lib` on checked tensors, on `stream`;
    returns its cudaError_t. The kernel's 32-base compare of the node
    records answers every probe up to 32 bases (its prefix64
    instantiation); past 32 a tie reads the packed genome."""
    return lib.fancy_binsearch_launch(
        packed.data_ptr(), packed.shape[0], nodes.data_ptr(),
        q_words.data_ptr(), out.data_ptr(), _ptr(lane), _ptr(depth),
        _ptr(trace), q_words.shape[1], n, length,
        0 if trace is None else trace.shape[1],
        PROBES["prefix64" if length <= 32 else "packed"], stream)


def _check_tables(rev, llcp, rlcp, n: int, dev) -> None:
    if not 1 <= n < 1 << 31:
        raise ValueError(f"the pruned search needs 1 <= n < 2^31, got {n}")
    _check("rev", rev, _REV, (n,), dev, at_least=True)
    _check("llcp", llcp, (torch.int32,), (n,), dev, at_least=True)
    _check("rlcp", rlcp, (torch.int32,), (n,), dev, at_least=True)


def fancy_nodes_cuda(packed, rev, llcp, rlcp, *, n: int, rank_recs=None):
    """ops.query.fancy_nodes (the pruned search's int64 [n, 4] node
    records) on records_kernel for tensors on the card, with the
    arguments fancy_binsearch_cuda takes (packed also as its 32-bit form,
    genome32). `rank_recs`, the rank records plquery_records_cuda made of
    the same packed and rev (a caller that holds them: SaplingIndex past
    the card's L2), give the records' first halves as a stream, where the
    genome's gathers would miss the L2 (230 Mbp: 2.2x faster on an H100);
    without them the kernel gathers the keys. Tensors on the CPU take the
    plain version (rank_recs unread)."""
    if packed.device.type == "cpu":
        return query.fancy_nodes(packed, rev, llcp, rlcp, n=n)
    _check_tables(rev, llcp, rlcp, n, packed.device)
    return _records("fancy_nodes", packed, rev, llcp, rlcp, n, rank_recs)


def fancy_binsearch_cuda(packed, rev, llcp, rlcp, q_words, *, n: int,
                         length: int, prefix=None, nodes=None,
                         stats: bool = False, trace: int = 0):
    """ops.query.fancy_binsearch_batch with the same arguments and results,
    on fancy_binsearch_kernel for tensors on the card: packed int64, rev
    int32 (uint32 bits) or int64, llcp / rlcp int32 [n], q_words int64
    [ceil(L/16), B], all contiguous on one device; n < 2^31 (the lane
    state is 32-bit). prefix (int64 or None) is the plain version's: on
    the card the node records' 32-base keys answer every probe up to 32
    bases. `nodes` are the node records fancy_nodes_cuda made of the same
    packed, rev, llcp and rlcp; a call without them on the card makes them
    first (one more launch), so a caller that searches more than once
    passes them. On the CPU they are not read: the plain version reads the
    tables. The kernel reads rev, llcp and rlcp only through the records,
    adds no rounds (the plain version has none), and with stats records
    the sectors a lane really reads: its node records and genome windows.
    Returns int64 [B] positions, -1 = not found."""
    if q_words.device.type == "cpu":
        return query.fancy_binsearch_batch(packed, rev, llcp, rlcp, q_words,
                                           n=n, length=length, prefix=prefix)
    dev = q_words.device
    if dev.type != "cuda":
        raise ValueError(f"fancy_binsearch_cuda: unsupported device {dev}")
    if length < 1:
        raise ValueError(f"query length {length} < 1")
    _check_tables(rev, llcp, rlcp, n, dev)
    _check("packed", packed, _I64, (1,), dev, at_least=True)
    b = q_words.shape[1]
    _check("q_words", q_words, _I64, (-(-length // BASES_PER_WORD), b), dev)
    if nodes is None:
        nodes = fancy_nodes_cuda(packed, rev, llcp, rlcp, n=n)
    _check("nodes", nodes, _I64, (n, 4), dev)
    _aligned("nodes", nodes, 32)
    out = torch.empty(b, dtype=torch.int64, device=dev)
    lane, depth, tr = stats_buffers(b, dev, stats, trace)
    if b:
        with torch.cuda.device(dev):
            rc = launch_fancy(
                _lib(), torch.cuda.current_stream(dev).cuda_stream, packed,
                nodes, q_words, out, lane, depth, tr, n=n, length=length)
        _launched("fancy", rc)
    if stats:
        _read_stats(lane, depth, tr)
    return out
