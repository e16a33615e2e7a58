"""The CUDA source of the query kernels, compiled for the CPU and held
against the plain plquery_batch / binsearch_batch / fancy_binsearch_batch,
bit for bit.

sapling_tpu_torch/csrc/query.cu is compiled with g++ against the stand-in
`cuda_runtime.h` of tests/csrc/cuda_mock/ (one std::thread a lane, __ldg a
plain load, __clz of 0 giving 32 as on the card, atomicMax a
compare-and-swap loop), after each `kernel<<<...>>>(args)` launch is
rewritten into a call of the mock's `mock_launch`. The wrapper's own
ctypes calls (ops.query_cuda.launch_plquery / launch_binsearch /
launch_fancy / launch_records) then run
the kernels' code on host tensors, so a fault in the cascade, a probe or
the prediction shows on the CPU: every position must equal the plain
PyTorch version's on the same tensors (itself held against sapling_tpu by
tests/test_torch_query*.py, test_torch_binsearch.py), -1s and the member
of a duplicate run included, and a subset equals sapling_tpu's own
query_positions. The stats the kernel writes on request must give the
plain versions' host loop rounds (ops.query.ROUNDS), and its sector trace
only sectors of the arrays it reads. The record builders (records_kernel)
must write the plain versions' records word for word. The library is
built with UBSan's alignment check, which aborts the run on a misaligned
load or store as the card would refuse it (the node records' stage in
shared memory is 16-byte loads and stores). Speed, registers and
the card's compiler are tested only on the card
(tests/test_torch_query_cuda.py, chip_smoke.py).
"""

import math
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sapling_tpu_torch.config import IndexConfig, QueryConfig
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.index.suffix_array import (build_llcp_rlcp,
                                                  build_suffix_data)
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.ops import query, query_cuda
from sapling_tpu_torch.ops.predict import predict_pwl
from sapling_tpu_torch.sim.genomes import benchmark_genome, repeat_genome

from .test_torch_query import GRID, _pair, _queries
from .test_torch_query_variants import _boundary_queries

MOCK_DIR = os.path.join(os.path.dirname(__file__), "csrc", "cuda_mock")
_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<([^>]*)>>>\((.*?)\);",
                     re.S)
_DYNAMIC_SMEM = re.compile(
    r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?([\w ]+?)\s+(\w+)\[\];")


def mock_source(src: str, launches: int) -> str:
    """A CUDA source with its `launches` kernel launch sites rewritten into
    the mock's mock_launch and its one dynamic shared memory declaration
    into the mock's buffer."""
    def launch(m):
        grid, block, smem, _stream = (x.strip() for x in m.group(2).split(","))
        return (f"mock_launch({grid}, {block}, {smem}, "
                f"[=] {{ {m.group(1)}({m.group(3)}); }});")

    src, n = _LAUNCH.subn(launch, src)
    assert n == launches, f"{n} launch sites, not {launches}"
    src, n = _DYNAMIC_SMEM.subn(
        lambda m: f"{m.group(1)}* {m.group(2)} = "
        f"reinterpret_cast<{m.group(1)}*>(mock_dynamic_smem());", src)
    assert n == 1, "the source should declare its dynamic shared memory once"
    return src


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("query_cu_on_cpu")
    probe = d / "probe.cpp"
    probe.write_text("#include <barrier>\nstd::barrier<> b(1);\n")
    if subprocess.run([gxx, "-std=c++20", "-fsyntax-only", str(probe)],
                      capture_output=True).returncode != 0:
        pytest.skip("the mock needs a g++ with C++20 <barrier>")
    cpp, so = d / "query_on_cpu.cpp", d / "libquery_on_cpu.so"
    with open(query_cuda.SOURCE) as f:
        # plquery launches at two rev types, the pruned search, the record
        # builders, the binary search and the bucket records from one
        # launcher each
        cpp.write_text(mock_source(f.read(), 6))
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", "-fsanitize=alignment",
                    "-fno-sanitize-recover=alignment", "-I", MOCK_DIR, "-o",
                    str(so), str(cpp)], check=True)
    return query_cuda.bind(str(so))


TRACE = 64   # sector numbers a lane records in the tests


def _check_trace(trace, sectors, arrays):
    """The first min(sectors, TRACE) entries of each lane's trace are the
    numbers of sectors inside the index arrays the kernel reads, the rest
    -1."""
    rec = trace >= 0
    want = np.minimum(sectors.numpy(), trace.shape[1])
    np.testing.assert_array_equal(rec.sum(1).numpy(), want)
    assert (rec == (torch.arange(trace.shape[1]) < torch.from_numpy(
        want)[:, None])).all()
    inside = torch.zeros_like(rec)
    for t in arrays:
        if t is not None:
            lo = t.data_ptr() >> 5
            hi = (t.data_ptr() + t.numel() * t.element_size() - 1) >> 5
            inside |= (trace >= lo) & (trace <= hi)
    assert (inside == rec).all()


_MADE = {}   # the mocked record tables of the last arrays (_mock_records)


def _made(name, arrays, build):
    """build() of these host tensors (the same objects, unwritten since),
    kept for the next call with them: the mock runs a thread a rank."""
    key = tuple(None if t is None else (id(t), t._version) for t in arrays)
    if name not in _MADE or _MADE[name][0] != key:
        # the tensors stay referenced, so their ids are not reused
        _MADE[name] = (key, arrays, build())
    return _MADE[name][2]


def _mock_built(lib, packed, rev, llcp, rlcp, n, rank_recs=None):
    """records_kernel's table through launch_records on host tensors: rank
    records (llcp None) or node records of the genome's int64 words
    narrowed to 32 bits (query_cuda.genome32, as on the card), rev and the
    tables, or of rank_recs and the tables where given; every word
    written."""
    recs = torch.full((n, 2 if llcp is None else 4), -9, dtype=torch.int64)
    words = query_cuda.genome32(packed)
    assert words.dtype == torch.int32 and words.shape == packed.shape
    assert query_cuda.launch_records(lib, None, words, rev, llcp, rlcp, recs,
                                     n=n, rank_recs=rank_recs) == 0
    return recs


def _mock_records(lib, xlist, ylist, bounds, packed, rev, *, buckets, n,
                  ranks=True):
    """plquery's record tables through launch_bucket_records /
    launch_records (the mocked record kernels, the rank records from the
    genome's 32-bit words) on host tensors, held equal to the plain
    ops.query.bucket_records / plquery_records word for word: (bucket
    records, rank records, or None without `ranks`)."""
    def bucket():
        recs = torch.full((1 << buckets, 4), -9, dtype=torch.int64)
        assert query_cuda.launch_bucket_records(
            lib, None, xlist, ylist, bounds, recs, buckets=buckets) == 0
        assert recs.equal(query.bucket_records(xlist, ylist, bounds,
                                               buckets=buckets))
        return recs

    def rank_records():
        recs = _mock_built(lib, packed, rev, None, None, n)
        assert recs.equal(query.plquery_records(packed, rev, n=n))
        return recs

    return (_made("bucket", (xlist, ylist, bounds), bucket),
            _made("rank", (packed, rev), rank_records) if ranks else None)


def _kernel_plquery(lib, args, kw, form="records"):
    """The kernel on plquery_batch's arguments (host tensors; q_words
    given) and on the record tables of the mocked record kernels
    (_mock_records), with the probe `form`: "fast3" (prefix3, with args'
    q3), "records" (rank records) or "arrays" (rev and the genome):
    (positions, int32 [2, B] probes and sectors a lane, [C, D] deepest
    steps, the int64 [B, TRACE] sector trace), the trace checked to hold
    only sectors of the arrays the kernel reads: the records, prefix3 and
    rev on fast3, rev without rank records, the packed genome, ylist for a
    wide bucket and bounds with pred64."""
    (packed, rev, xlist, ylist, q_words, x, _prefix, prefix3, q3,
     bounds) = args
    kw = dict(kw)
    pred64 = kw.pop("pred64", None)
    kw.setdefault("max_stride_steps", 1 << 20)
    kw.setdefault("adaptive_bounds", False)
    b = x.shape[0]
    out = torch.full((b,), -777, dtype=torch.int64)
    lane = torch.full((2, b), -1, dtype=torch.int32)
    depth = torch.zeros(2, dtype=torch.int32)
    trace = torch.full((b, TRACE), -5, dtype=torch.int64)
    bucket, rank = _mock_records(lib, xlist, ylist, bounds, packed, rev,
                                 buckets=kw["buckets"], n=kw["n"],
                                 ranks=form == "records")
    bucket = None if pred64 is not None else bucket
    fast3 = form == "fast3"
    assert not fast3 or q3 is not None
    rc = query_cuda.launch_plquery(
        lib, None, packed, rev, xlist, ylist, None if fast3 else q_words, x,
        prefix3, q3 if fast3 else None, bounds, pred64, out, lane, depth,
        trace, bucket_recs=bucket, rank_recs=rank, **kw)
    assert rc == 0
    _check_trace(trace, lane[1], (
        bucket, ylist, bounds if pred64 is not None else None, rank,
        rev if rank is None else None, None if fast3 else packed,
        prefix3 if fast3 else None))
    return out, lane, depth.tolist(), trace


def _forms(args, kw):
    """The kernel's probe forms a case runs: fast3 where plquery_batch
    takes it, rank records always, and rev and the genome where the index
    has no prefix arrays (the plain version's packed probe)."""
    fast3 = query_cuda.probe_form(kw["length"], kw["k"], args[6], args[7],
                                  args[8]) == "fast3"
    return (("fast3",) if fast3 else ()) + ("records",) + (
        ("arrays",) if args[6] is None else ())


def _check_plquery(lib, args, kw, want_c=None):
    """Kernel == plquery_batch on every lane, and its stats' deepest steps
    == the plain path's ROUNDS, at each of the case's probe forms
    (_forms); returns the positions and the rounds."""
    query.ROUNDS.update(C=0, D=0)
    want = query.plquery_batch(*args, **kw)
    rounds = dict(query.ROUNDS)
    for form in _forms(args, kw):
        got, lane, (c, d), _ = _kernel_plquery(lib, args, kw, form)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert (c, d) == (rounds["C"], rounds["D"])
        assert (lane[0] >= 1).all() and (lane[1] >= lane[0]).all()
        if want_c is not None:
            assert (c > 0) == want_c, rounds
    return got.numpy(), rounds


def _args(idx, codes, with_bounds=False):
    """plquery_batch's arguments on idx (on the CPU), q_words always (the
    kernel reads them; the plain version takes q3 where fast3 answers)."""
    dev = idx.device_arrays()
    x, q3, _ = idx.query_inputs(codes)
    return (dev["packed"], dev["rev"], dev["xlist"], dev["ylist"],
            idx.query_words(codes), x, dev["prefix64"], dev["prefix3"], q3,
            dev["bounds"] if with_bounds else None)


def _kw(idx, length, qcfg=None, **over):
    t = idx.table
    qcfg = qcfg or QueryConfig()
    kw = dict(n=idx.n, length=length, k=idx.k, buckets=idx.buckets,
              most_over=t.most_over, most_under=t.most_under,
              max_over=t.max_over, max_under=t.max_under,
              max_stride_steps=qcfg.max_stride_steps,
              adaptive_bounds=qcfg.adaptive_bounds)
    kw.update(over)
    return kw


def _index(seq, k, buckets, **cfg):
    return SaplingIndex.build(seq, IndexConfig(k=k, buckets=buckets, **cfg),
                              device="cpu")


def _bare(idx):
    """idx without prefix64/prefix3: every probe reads the packed genome."""
    out = SaplingIndex.from_arrays(idx, device="cpu")
    out.prefix64 = out.prefix3 = None
    return out


def _prediction_args(xlist, ylist, x, n):
    """plquery_batch's arguments that read the prediction back: a genome of
    n A's whose rev is the identity and one-base queries of A, so that the
    prediction probe matches at every rank and answers the predicted rank
    (ylist / xlist / x int64 arrays; no bounds)."""
    t = [torch.from_numpy(np.ascontiguousarray(a, np.int64))
         for a in (xlist, ylist, x)]
    b = len(x)
    return (torch.zeros(n // 16 + 16, dtype=torch.int64),
            torch.arange(n, dtype=torch.int32), t[0], t[1],
            torch.zeros((1, b), dtype=torch.int64), t[2], None, None, None,
            None)


def test_prediction_kernel_source_matches_predict_pwl(lib):
    """The kernel's prediction, read through an index whose every rank
    matches the query (so the prediction probe answers) and whose rev is
    the identity (so the position is the predicted rank:
    _prediction_args): equal to ops.predict.predict_pwl on crafted
    checkpoints, with ties that round half up on both sides of xlo, empty
    buckets (d == 0), x below its bucket's xlo, and predictions clipped at
    0 and n - 1."""
    k, buckets, n, b = 21, 6, 1 << 16, 4000
    nb = 1 << buckets
    rng = np.random.default_rng(17)
    shift = 2 * k - buckets
    starts = np.arange(nb + 1, dtype=np.int64) << shift
    xlist = starts + rng.integers(-(1 << 20), 1 << 20, nb + 1)
    xlist[5:9] = xlist[4]                     # empty buckets: d == 0
    # bucket 9: xlo 1,000 past its first k-mer, d == 2, m == 3, so x = xlo
    # + 1 and x = xlo - 1 fall on halves (3 * 1 / 2)
    xlist[9] = starts[9] + 1000
    xlist[10] = xlist[9] + 2
    ylist = np.sort(rng.integers(-500, n + 500, nb + 1))
    ylist[10:] += ylist[9] + 3 - ylist[10]
    x = rng.integers(0, nb << shift, b)
    x[:80] = xlist[9] + rng.integers(-2, 3, 80)
    args = _prediction_args(xlist, ylist, x, n)
    want = predict_pwl(args[5], args[2], args[3], 2 * k, buckets, n)
    kw = dict(n=n, length=1, k=k, buckets=buckets, most_over=5,
              most_under=5, max_over=9, max_under=9)
    for form in ("records", "arrays"):
        got, _, _, _ = _kernel_plquery(lib, args, kw, form)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), query.plquery_batch(*args, **kw).numpy())
    assert 0 in got and n - 1 in got
    assert b == len(got)


def test_prediction_wide_products_kernel_source(lib):
    """The kernel's prediction (read as above) where M*N passes 2^53 (an
    fp64 product is no longer exact) and 2^61, with exact ties, x - xlo =
    +-D/2 (D even, M odd), and x at every checkpoint and +-1 beside it, an
    empty bucket (d == 0) among them: equal to predict_pwl on every lane."""
    k, buckets = 21, 4
    nb, shift, n = 1 << buckets, 2 * k - buckets, 1 << 22
    rng = np.random.default_rng(29)
    # even checkpoints, alternately 2^37 and 2^35 (plus up to 2^20) into
    # their bucket, so that x - xlo = -D/2 and +D/2 both fall inside some
    # buckets
    small = 2 * rng.integers(1 << 18, 1 << 19, nb + 1)
    xlist = ((np.arange(nb + 1, dtype=np.int64) << shift) + small
             + np.where(np.arange(nb + 1) % 2 == 0, 1 << 37, 1 << 35))
    xlist[nb] = (nb << shift) - 2                 # the last checkpoint < 4^k
    m = 2 * rng.integers(1 << 15, 1 << 16, nb) + 1          # odd, ~2^17
    xlist[6] = xlist[7]                           # bucket 6 empty: d == 0
    d = np.diff(xlist)
    # M*N ~ 2^60, with M prime to D (remainders 1 and 2 reachable below);
    # M*N past 2^61 (clipped)
    m[nb - 2] = next(v for v in range((1 << 23) + 1, 1 << 24, 2)
                     if math.gcd(v, int(d[nb - 2])) == 1)
    m[nb - 1] = (1 << 24) + 1
    ylist = np.concatenate([[-7], -7 + np.cumsum(m)])
    lo = np.arange(nb, dtype=np.int64) << shift
    x = [lo + 1, lo + (1 << shift) - 1]
    for t in (-1, 0, 1):
        x += [xlist[:nb] + t, xlist[:nb] + d // 2 + t, xlist[:nb] - d // 2 + t]
    # remainders 1, 2, d - 2 and d - 1, where an fp64 estimate of the
    # quotient may miss the floor
    for i in range(nb):
        dd, mm = int(d[i]), int(m[i])
        if dd and math.gcd(mm, dd) == 1:
            inv = pow(mm, -1, dd)
            for r in (1, 2, dd - 2, dd - 1):
                cand = np.array([xlist[i] + sign * (r * inv % dd + j * dd)
                                 for sign in (1, -1) for j in (0, 1)])
                x.append(cand[(cand >> shift) == i])
    x = np.concatenate(x + [rng.integers(0, nb << shift, 3000)])
    x = x[(x >= lo[0]) & (x < nb << shift)]
    b = len(x)
    # the cases the test is for are there
    bucket = x >> shift
    nn = x - xlist[bucket]
    prod = [int(a) * abs(int(c)) for a, c in zip(np.diff(ylist)[bucket], nn)]
    assert max(prod) > 1 << 61 and sum(p > 1 << 53 for p in prod) > 100
    ties = np.array([dd > 0 and 2 * (p % int(dd)) == dd
                     for p, dd in zip(prod, d[bucket])])
    assert ties[nn > 0].sum() >= nb // 2 and ties[nn < 0].sum() >= nb // 4
    # the float64 estimate M*|N|/D (as g++ rounds it) misses the floor on
    # some lanes, so that a correction runs
    exact = [p // int(dd) if dd else 0 for p, dd in zip(prod, d[bucket])]
    est = (np.diff(ylist)[bucket].astype(np.float64)
           * np.abs(nn).astype(np.float64) / np.maximum(d[bucket], 1))
    off = est.astype(np.int64) - np.array(exact)
    assert (off[est < 2.0 ** 50] != 0).any()
    args = _prediction_args(xlist, ylist, x, n)
    want = predict_pwl(args[5], args[2], args[3], 2 * k, buckets, n)
    assert ((want > 0) & (want < n - 1)).sum() > b // 2
    kw = dict(n=n, length=1, k=k, buckets=buckets, most_over=5,
              most_under=5, max_over=9, max_under=9)
    # rev and the genome: the rank records of 2^22 ranks take the mock a
    # thread each (the other prediction tests read them)
    got, _, _, _ = _kernel_plquery(lib, args, kw, "arrays")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _wide_table(k, buckets, n, seed):
    """Checkpoints whose buckets span past 32 bits of ranks: even buckets
    rise by 2^32 - 2 (the largest yhi - ylo a bucket record holds), 2^32 -
    1, 2^32, 2^33 + 3 and 2^40 (the record then says "read ylist"), each
    centred on a rank inside [0, n); odd ones fall back (negative), the
    last two rise by 0 and 5. x at and around each bucket's middle and its
    xlo. Returns (xlist, ylist, x) as int64 arrays."""
    nb, shift = 1 << buckets, 2 * k - buckets
    rng = np.random.default_rng(seed)
    xlist = (np.arange(nb + 1, dtype=np.int64) << shift) + rng.integers(
        0, 1 << 20, nb + 1)
    xlist[nb] = (nb << shift) - 1
    rises = [(1 << 32) - 2, (1 << 32) - 2, (1 << 32) - 1, (1 << 32) - 1,
             1 << 32, (1 << 33) + 3, 1 << 40]
    ylist = np.full(nb + 1, n // 3, dtype=np.int64)
    for j, v in enumerate(rises[:nb // 2 - 1]):
        ylist[2 * j] -= v // 2
        ylist[2 * j + 1] += v - v // 2
    ylist[nb] += 5
    d = np.diff(xlist)
    m = np.diff(ylist)
    mid = xlist[:nb] + d // 2
    # around the middle: a rank step every d / |m| k-mers
    steps = np.maximum(d // np.maximum(np.abs(m), 1), 1)
    x = np.concatenate([mid[:, None] + steps[:, None]
                        * rng.integers(-n // 2, n // 2, (nb, 60)),
                        xlist[:nb, None] + rng.integers(-3, 4, (nb, 6))],
                       axis=1).ravel()
    x = x[(x >= 0) & (x < nb << shift)]
    return xlist, ylist, x


def test_prediction_wide_buckets_kernel_source(lib):
    """The kernel's prediction (read as above) on buckets whose yhi - ylo
    lies at a bucket record's edges: 2^32 - 2 in the record, 2^32 - 1,
    2^32, past 2^33 and 2^40, and falling, through ylist: equal to
    predict_pwl on every lane, and most lanes predict inside (0, n - 1)."""
    k, buckets, n = 21, 4, 1 << 16
    xlist, ylist, x = _wide_table(k, buckets, n, seed=3)
    args = _prediction_args(xlist, ylist, x, n)
    t = dict(xlist=args[2], ylist=args[3], x=args[5])
    recs = query.bucket_records(t["xlist"], t["ylist"], buckets=buckets)
    m32 = recs[:, 3] & 0xFFFFFFFF
    assert int(m32[0]) == (1 << 32) - 2
    assert (m32 == query.WIDE_M).sum() >= 9   # 2^32 - 1 and past, falling
    want = predict_pwl(t["x"], t["xlist"], t["ylist"], 2 * k, buckets, n)
    bucket = t["x"] >> (2 * k - buckets)
    for i in range(0, 14, 2):   # the rising buckets predict inside
        inside = ((want > 0) & (want < n - 1))[bucket == i]
        assert inside.float().mean() > 0.15, i
    kw = dict(n=n, length=1, k=k, buckets=buckets, most_over=5,
              most_under=5, max_over=9, max_under=9)
    got, _, _, trace = _kernel_plquery(lib, args, kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # a wide bucket's lanes read ylist, the others only their record
    ylist_lo, ylist_hi = _sector(t["ylist"], 0), _sector(t["ylist"], 16)
    read_ylist = ((trace >= ylist_lo) & (trace <= ylist_hi)).any(1)
    assert read_ylist.equal((m32 == query.WIDE_M)[bucket])


@pytest.mark.parametrize("rev64", [False, True], ids=["rev32", "rev64"])
@pytest.mark.parametrize("pad", [16, 1, 0])
def test_record_kernels_source(lib, dup_genome, pad, rev64):
    """plquery's record tables, plain (ops.query.plquery_records,
    bucket_records) and the mocked record kernels, word for word: the rank
    records are the node records' first half (the suffix's first 32
    bases, rev) at every pad; the bucket records hold xlist[b],
    xlist[b + 1], ylist[b] and yhi - ylo | bounds << 32, with the largest
    yhi - ylo a record holds (2^32 - 2), WIDE_M past it and for a falling
    ylist, and bounds words 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF and 0 (and
    0 without bounds)."""
    seq = dup_genome[:2500]
    n = len(seq)
    codes = packops.encode_bases(seq)
    sa = build_suffix_data(seq, np.int32).sa
    rev = torch.from_numpy(sa.astype(np.int64 if rev64 else np.int32))
    packed = torch.from_numpy(
        packops.pack_codes(codes, pad_words=pad).astype(np.int64))
    llcp, rlcp = _tables(seq)
    buckets = 5
    xlist, ylist, _x = _wide_table(21, buckets, n, seed=pad)
    xlist, ylist = torch.from_numpy(xlist), torch.from_numpy(ylist)
    rng = np.random.default_rng(pad)
    bw = rng.integers(0, 1 << 32, 1 << buckets, dtype=np.uint64).astype(
        np.uint32)
    bw[:4] = [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0]
    bounds = torch.from_numpy(bw.view(np.int32))
    for bnd in (bounds, None):
        recs, ranks = _mock_records(lib, xlist, ylist, bnd, packed, rev,
                                    buckets=buckets, n=n)
        got = recs.numpy().view(np.uint64)
        np.testing.assert_array_equal(recs[:, 0].numpy(), xlist[:-1])
        np.testing.assert_array_equal(recs[:, 1].numpy(), xlist[1:])
        np.testing.assert_array_equal(recs[:, 2].numpy(), ylist[:-1])
        m = np.diff(ylist.numpy())
        inline = (m >= 0) & (m < query.WIDE_M)
        np.testing.assert_array_equal(
            got[:, 3] & np.uint64(0xFFFFFFFF),
            np.where(inline, m, query.WIDE_M).astype(np.uint64))
        assert inline.sum() >= 6 and (~inline).sum() >= 9
        assert int(m[0]) == (1 << 32) - 2 and inline[0]
        np.testing.assert_array_equal(
            got[:, 3] >> np.uint64(32),
            bw.astype(np.uint64) if bnd is not None else 0)
    assert ranks.equal(query.fancy_nodes(packed, rev, llcp, rlcp,
                                         n=n)[:, :2])
    np.testing.assert_array_equal(ranks[:, 1].numpy(), sa)


@pytest.mark.parametrize("rev64", [False, True], ids=["rev32", "rev64"])
@pytest.mark.parametrize("n,pad", [(2, 0), (3, 1), (33, 0), (1023, 1),
                                   (1025, 0), (2053, 1)])
def test_records_kernel_edges_source(lib, n, pad, rev64):
    """records_kernel where n is not a multiple of a block's 256 ranks (or
    of a warp's 32), with few pad words: the rank and node records equal
    the plain versions word for word, made from the int64 words narrowed
    to 32 bits (query_cuda.genome32, as the wrappers do) and from the
    host's uint32 words viewed as int32 (the same words), and the node
    records also from the rank records (their first halves copied). The
    ranks cover a suffix at a multiple of 16 (no shift: the key is two
    whole words) and keys whose word indexes clamp at the array's end."""
    seq = repeat_genome(n, period=min(37, n), seed=n)
    codes = packops.encode_bases(seq)
    sa = build_suffix_data(seq, np.int32).sa
    rev = torch.from_numpy(sa.astype(np.int64 if rev64 else np.int32))
    words = packops.pack_codes(codes, pad_words=pad)
    packed = torch.from_numpy(words.astype(np.int64))
    host32 = torch.from_numpy(words.view(np.int32))
    assert query_cuda.genome32(packed).equal(host32)
    assert query_cuda.genome32(host32) is host32
    llcp, rlcp = _tables(seq)
    for tabs, want in (
            ((None, None), query.plquery_records(packed, rev, n=n)),
            ((llcp, rlcp), query.fancy_nodes(packed, rev, llcp, rlcp, n=n))):
        for w in (query_cuda.genome32(packed), host32):
            recs = torch.full(want.shape, -9, dtype=torch.int64)
            assert query_cuda.launch_records(lib, None, w, rev, *tabs, recs,
                                             n=n) == 0
            assert recs.equal(want), f"n={n} pad={pad} {want.shape}"
        if tabs[0] is not None:
            ranks = _mock_built(lib, packed, rev, None, None, n)
            assert _mock_built(lib, packed, rev, *tabs, n, ranks).equal(want)
    assert (sa % 16 == 0).any()
    assert ((sa >> 4) + 2 > len(words) - 1).any()


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_adaptive_bounds_words_kernel_source(lib, k21, prefix):
    """adaptive_bounds with the bucket records' bounds words at their
    edges (0xFFFFFFFF and 0xFFFF halves: the 'most' window; 0: the
    prediction alone; a wide over and a narrow under, and the reverse),
    with the table's own prediction and, through pred64 (which reads the
    bounds array), a shifted one."""
    idx = k21 if prefix else _bare(k21)
    dev = idx.device_arrays()
    bw = dev["bounds"].clone()
    edges = torch.tensor([-1, 0, 0xFFFF, -65536, 0x00400001, 0x00010040],
                         dtype=torch.int32)
    bw[::3] = edges.repeat(bw[::3].numel() // 6 + 1)[:bw[::3].numel()]
    for length in (21, 33):
        codes = _queries(idx.codes, 1500, length, seed=71 + length)
        args = _args(idx, codes, with_bounds=True)[:-1] + (bw,)
        _check_plquery(lib, args, _kw(idx, length,
                                      QueryConfig(adaptive_bounds=True)))
        pred = _shifted_pred(idx, codes, 200, seed=length)
        _check_plquery(lib, args, _kw(idx, length, QueryConfig(
            adaptive_bounds=True), pred64=pred))


@pytest.mark.parametrize("form", ["records", "arrays", "fast3"])
def test_plquery_trace_reads_records(lib, k21, form):
    """The sectors a plquery lane reads, from its trace: with the table's
    prediction one bucket record; then with rank records one a probe (and
    the hi == lo + 2 base case's), the packed genome only on a tie of all
    32 bases past 32 (never up to 32), never rev; without them rev a probe
    (and the base case's) and the genome's windows; on fast3 prefix3 a
    probe and rev once for a hit; never prefix64, xlist, ylist or bounds
    (adaptive bounds come with the bucket record)."""
    dev = k21.device_arrays()

    def span(t):
        return (_sector(t, 0), _sector(t, t.numel() - 1))

    for length in (11, 21) if form == "fast3" else (11, 21, 32, 33, 45):
        codes = _mixed_codes(k21.codes, 2000, length, seed=length)
        args = _args(k21, codes, with_bounds=True)
        kw = _kw(k21, length, QueryConfig(adaptive_bounds=True))
        got, lane, _, trace = _kernel_plquery(lib, args, kw, form)
        probes, sectors = lane[0].long(), lane[1].long()
        hits = {}
        for name in ("packed", "rev", "prefix64", "prefix3", "xlist",
                     "ylist", "bounds"):
            lo, hi = span(dev[name])
            hits[name] = ((trace >= lo) & (trace <= hi)).sum(1)
        for name in ("prefix64", "xlist", "ylist", "bounds"):
            assert int(hits[name].sum()) == 0, name
        genome, rev = hits["packed"], hits["rev"]
        if form == "fast3":
            assert hits["prefix3"].equal(probes) and genome.sum() == 0
            assert rev.equal((got >= 0).long())
            assert (sectors == 1 + probes + rev).all()
            continue
        assert hits["prefix3"].sum() == 0
        if form == "records":
            assert rev.sum() == 0
            rest = sectors - genome - probes - 1
            if length <= 32:
                assert genome.sum() == 0
            elif length == 33:
                assert (genome > 0).any()
        else:
            assert (genome >= probes).all()
            rest = rev - probes
            assert (sectors == 1 + rev + genome).all()
        # the base case's record or rev sector, or none
        assert ((rest >= 0) & (rest <= 1)).all() and (rest == 1).any()


@pytest.mark.parametrize("gen,k,buckets,length", GRID)
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_plquery_kernel_source_matches_plain(lib, gen, k, buckets, length,
                                             prefix):
    """tests/test_torch_query.py's grid, with and without prefix arrays
    (the plain version's fast3, prefix64 and packed probes; the kernel on
    rank records and, without prefix arrays, also on rev and the
    genome)."""
    seq = gen()
    idx = _index(seq, k, buckets, prefix_lookup=prefix)
    codes = _queries(seq, 2000, length, seed=99)
    _check_plquery(lib, _args(idx, codes), _kw(idx, length))


@pytest.mark.parametrize("gen,k,buckets,length",
                         [GRID[0], GRID[2], GRID[4], GRID[7]])
def test_kernel_source_matches_sapling_tpu(lib, gen, k, buckets, length):
    """A subset of the grid against sapling_tpu's own query_positions: the
    slice as a whole, held against JAX."""
    seq = gen()
    jidx, tidx = _pair(seq, k, buckets)
    codes = _queries(seq, 1000, length, seed=7)
    want = np.asarray(jidx.query_positions(codes))
    for idx in (tidx, _bare(tidx)):
        got, _ = _check_plquery(lib, _args(idx, codes), _kw(idx, length))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_length_sweep_kernel_source(lib, prefix):
    """The reference's sweep k-10 ... k+80, and a length past the seven
    query words a probe holds in registers (a second window)."""
    seq = repeat_genome(4000, 37, seed=40)
    k = 12
    idx = _index(seq, k, 8, prefix_lookup=prefix)
    for length in (k - 10, k, k + 10, k + 20, k + 30, k + 80, 130):
        codes = _queries(seq, 800, length, seed=41 + length)
        got, _ = _check_plquery(lib, _args(idx, codes), _kw(idx, length))
        assert idx.verify_hits(codes, got)[:800].all(), length


@pytest.fixture(scope="module")
def k21():
    """One k=21 index with duplications (test_torch_query_variants's)."""
    seq = np.concatenate([repeat_genome(3000, period=48, seed=83),
                          benchmark_genome(27_000, seed=84)])
    return _index(seq, 21, 9)


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_boundary_queries_kernel_source(lib, k21, prefix):
    """Poly-A, poly-T, genome-tail and absent queries through every probe
    form (the plain version's fast3 11/21, prefix64 31/32, packed 45; the
    kernel's key up to 32 bases, records and arrays past)."""
    idx = k21 if prefix else _bare(k21)
    for length in (11, 21, 31, 32, 45):
        codes = _boundary_queries(idx, length, 1500, seed=length)
        _check_plquery(lib, _args(idx, codes), _kw(idx, length))


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_adaptive_bounds_kernel_source(lib, k21, prefix):
    idx = k21 if prefix else _bare(k21)
    assert idx.table.bounds is not None
    for length in (11, 21, 33, 45):
        codes = _queries(idx.codes, 1500, length, seed=61 + length)
        _check_plquery(lib, _args(idx, codes, with_bounds=True),
                       _kw(idx, length, QueryConfig(adaptive_bounds=True)))


def _shifted_pred(idx, codes, shift, seed):
    """The PWL prediction moved by up to +-shift ranks (seeded)."""
    x = torch.from_numpy(idx.kmerize_batch(codes))
    t = idx.table
    base = predict_pwl(x, torch.from_numpy(t.xlist),
                       torch.from_numpy(t.ylist), 2 * idx.k, idx.buckets,
                       idx.n)
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.integers(-shift, shift + 1, len(codes)))
    return torch.clamp(base + noise, 0, idx.n - 1)


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_pred64_kernel_source(lib, k21, prefix):
    """Shifted predictions through the pred64 seam: with the table's own
    windows, so that lanes escalate to the max window and, past k, run the
    stride scan; and with windows widened to cover the shift."""
    idx = k21 if prefix else _bare(k21)
    t = idx.table
    wide = dict(most_over=t.most_over + 300, most_under=t.most_under + 300,
                max_over=t.max_over + 300, max_under=t.max_under + 300)
    for length in (16, 21, 33, 45):
        codes = _queries(idx.codes, 1500, length, seed=5 + length)
        pred = _shifted_pred(idx, codes, 300, seed=length)
        args = _args(idx, codes)
        _check_plquery(lib, args, _kw(idx, length, pred64=pred),
                       want_c=length > idx.k)
        _check_plquery(lib, args, _kw(idx, length, pred64=pred, **wide))


@pytest.mark.parametrize("steps", [1, 2])
def test_max_stride_steps_kernel_source(lib, k21, steps):
    """The phase C cap on lanes that scan (shifted predictions)."""
    for idx in (k21, _bare(k21)):
        for length in (33, 60):
            codes = _queries(idx.codes, 1500, length, seed=9 + length)
            pred = _shifted_pred(idx, codes, 400, seed=3)
            _, rounds = _check_plquery(
                lib, _args(idx, codes),
                _kw(idx, length, max_stride_steps=steps, pred64=pred))
            assert rounds["C"] == steps


@pytest.mark.parametrize("pos_dtype", ["uint32", "int64"])
def test_rank_storage_kernel_source(lib, pos_dtype):
    """rev as an int32 view holding uint32 bits, and as int64."""
    seq = benchmark_genome(30_000, seed=91)
    idx = _index(seq, 21, 10, pos_dtype=pos_dtype)
    want_dtype = torch.int64 if pos_dtype == "int64" else torch.int32
    assert idx.device_arrays()["rev"].dtype == want_dtype
    for form_idx in (idx, _bare(idx)):
        for length in (16, 21, 31, 45):
            codes = _queries(seq, 1000, length, seed=length)
            _check_plquery(lib, _args(form_idx, codes),
                           _kw(form_idx, length))


def _kernel_binsearch(lib, packed, rev, q_words, n, length):
    b = q_words.shape[1]
    out = torch.full((b,), -777, dtype=torch.int64)
    lane = torch.full((2, b), -1, dtype=torch.int32)
    depth = torch.zeros(2, dtype=torch.int32)
    trace = torch.full((b, TRACE), -5, dtype=torch.int64)
    rc = query_cuda.launch_binsearch(lib, None, packed, rev, q_words, out,
                                     lane, depth, trace, n=n, length=length)
    assert rc == 0
    _check_trace(trace, lane[1], (packed, rev))
    return out, lane, depth.tolist()


@pytest.mark.parametrize("pos_dtype", ["int32", "uint32", "int64"])
def test_binsearch_kernel_source_matches_plain(lib, pos_dtype):
    """The classic binary search, absent and boundary queries included, at
    lengths from below k to past one register window."""
    seq = np.concatenate([repeat_genome(2000, period=31, seed=5),
                          benchmark_genome(8000, seed=6)])
    idx = _index(seq, 16, 8, pos_dtype=pos_dtype)
    dev = idx.device_arrays()
    for length in (5, 16, 21, 40, 130):
        codes = _boundary_queries(idx, length, 1000, seed=length)
        qw = idx.query_words(codes)
        query.ROUNDS.update(C=0, D=0)
        want = query.binsearch_batch(dev["packed"], dev["rev"], qw,
                                     n=idx.n, length=length)
        got, lane, (c, d) = _kernel_binsearch(lib, dev["packed"],
                                              dev["rev"], qw, idx.n, length)
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=f"L={length}")
        assert (c, d) == (0, query.ROUNDS["D"])
        assert (lane[0] >= 1).all() and (lane[1] >= lane[0]).all()


def _mixed_codes(codes, b, length, seed, absent=0.25):
    """b queries in a seeded shuffled order: substrings of the genome and a
    share of random (mostly absent) ones."""
    rng = np.random.default_rng(seed)
    n_abs = int(b * absent)
    starts = rng.integers(0, len(codes) - length + 1, b - n_abs)
    q = np.concatenate([codes[starts[:, None] + np.arange(length)],
                        rng.integers(0, 4, (n_abs, length)).astype(np.uint8)])
    return q[rng.permutation(b)]


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_queued_lanes_kernel_source(lib, k21, prefix):
    """A shuffled batch of hits and misses over 33 blocks, whose first four
    warps miss their prediction probe on every lane and whose last block
    is partial; every probe form, as built, with adaptive bounds and with a
    shifted pred64."""
    idx = k21 if prefix else _bare(k21)
    b = 32 * 256 + 77
    rng = np.random.default_rng(23)
    for length in (21, 31, 45):
        codes = _mixed_codes(idx.codes, b, length, seed=length)
        codes[:128] = rng.integers(0, 4, (128, length))
        args = _args(idx, codes, with_bounds=True)
        _check_plquery(lib, args, _kw(idx, length))
        _check_plquery(lib, args, _kw(idx, length,
                                      QueryConfig(adaptive_bounds=True)))
        pred = _shifted_pred(idx, codes, 300, seed=length)
        _check_plquery(lib, args, _kw(idx, length, pred64=pred),
                       want_c=length > idx.k)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 8, 33, 100, 1000, 4094,
                               4095, 4096, 4097, 6000])
def test_binsearch_tree_kernel_source(lib, n):
    """binsearch_kernel's shared table at genome lengths whose bisection
    has fewer levels than the table, about as many, and more: periodic
    genomes (duplicate runs, suffixes that tie on the table's 32-base key)
    at L <= 32 (the key decides), L = 33 (a tie reads the genome) and
    L = 101, with in-genome, genome-tail, poly-A / poly-T and random
    queries; int32 and int64 rev."""
    seq = repeat_genome(n, period=min(7, n), seed=n)
    codes = packops.encode_bases(seq)
    sa = build_suffix_data(seq, np.int32).sa
    packed = torch.from_numpy(
        packops.pack_codes(codes, pad_words=16).astype(np.int64))
    rng = np.random.default_rng(n)
    for length in (1, 5, 16, 32, 33, 101):
        tiled = np.tile(codes, -(-(length + n) // n))
        starts = rng.integers(0, n, 200)
        q = np.concatenate([
            tiled[starts[:, None] + np.arange(length)],     # wraps: absent
            rng.integers(0, 4, (60, length)).astype(np.uint8),
            np.zeros((5, length), np.uint8), np.full((5, length), 3,
                                                     np.uint8)])
        if length <= n:
            q[:100] = codes[rng.integers(0, n - length + 1, 100)[:, None]
                            + np.arange(length)]
            q[100] = codes[n - length:]
        qw = torch.from_numpy(packops.pack_queries(q).astype(np.int64))
        for rev in (torch.from_numpy(sa.astype(np.int32)),
                    torch.from_numpy(sa.astype(np.int64))):
            query.ROUNDS.update(C=0, D=0)
            want = query.binsearch_batch(packed, rev, qw, n=n,
                                         length=length)
            got, lane, (c, d) = _kernel_binsearch(lib, packed, rev, qw, n,
                                                  length)
            np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                          err_msg=f"n={n} L={length}")
            assert (c, d) == (0, query.ROUNDS["D"])
            assert (lane[0] >= 1).all() and (lane[1] >= lane[0]).all()


def test_wrappers_take_the_plain_path_on_the_cpu(k21):
    """plquery_cuda / binsearch_cuda / fancy_binsearch_cuda /
    fancy_nodes_cuda / bucket_records_cuda / plquery_records_cuda on host
    tensors are the plain versions, and launch nothing; an index on the
    CPU makes no node records and no plquery records."""
    codes = _queries(k21.codes, 300, 33, seed=1)
    args, kw = _args(k21, codes), _kw(k21, 33)
    before = dict(query_cuda.LAUNCHES)
    np.testing.assert_array_equal(
        query_cuda.plquery_cuda(*args, stats=True, **kw).numpy(),
        query.plquery_batch(*args, **kw).numpy())
    dev = k21.device_arrays()
    qw = k21.query_words(codes)
    np.testing.assert_array_equal(
        query_cuda.binsearch_cuda(dev["packed"], dev["rev"], qw, n=k21.n,
                                  length=33).numpy(),
        query.binsearch_batch(dev["packed"], dev["rev"], qw, n=k21.n,
                              length=33).numpy())
    seq = k21.codes
    llcp, rlcp = _tables(packops.decode_bases(seq))
    np.testing.assert_array_equal(
        query_cuda.fancy_binsearch_cuda(
            dev["packed"], dev["rev"], llcp, rlcp, qw, n=k21.n, length=33,
            prefix=dev["prefix64"]).numpy(),
        query.fancy_binsearch_batch(dev["packed"], dev["rev"], llcp, rlcp,
                                    qw, n=k21.n, length=33).numpy())
    assert query_cuda.fancy_nodes_cuda(dev["packed"], dev["rev"], llcp,
                                       rlcp, n=k21.n).equal(
        query.fancy_nodes(dev["packed"], dev["rev"], llcp, rlcp, n=k21.n))
    assert k21.fancy_nodes(llcp, rlcp) is None
    assert query_cuda.bucket_records_cuda(
        dev["xlist"], dev["ylist"], dev["bounds"], buckets=k21.buckets).equal(
        query.bucket_records(dev["xlist"], dev["ylist"], dev["bounds"],
                             buckets=k21.buckets))
    assert query_cuda.plquery_records_cuda(dev["packed"], dev["rev"],
                                           n=k21.n).equal(
        query.plquery_records(dev["packed"], dev["rev"], n=k21.n))
    assert k21.query_records() == (None, None)
    assert query_cuda.LAUNCHES == before


# --- the llcp/rlcp-pruned binary search --------------------------------

FANCY_TRACE = 160   # every sector of a lane at these sizes


def _tables(seq):
    """The int32 [n] llcp / rlcp tensors of a genome (ASCII bases)."""
    lcp = build_suffix_data(seq).lcp
    return tuple(torch.from_numpy(a) for a in build_llcp_rlcp(
        np.asarray(lcp, np.int64), len(seq)))


def _fancy_replica(codes, rev, llcp, rlcp, q, n):
    """tests/test_fancy.py's scalar fancyBinarySearch, also counting the
    lane's probes and whether it ended on the hi == lo + 2 base case, and
    listing what it read in order: ("llcp" | "rlcp", mid), ("probe", rank,
    pos), ("base", rank). Returns (position, probes, base, events)."""
    length = len(q)
    probes = 0
    events = []

    def probe(rank):
        nonlocal probes
        probes += 1
        idx = int(rev[rank])
        events.append(("probe", rank, idx))
        lcp = 0
        while idx + lcp < n and lcp < length and codes[idx + lcp] == q[lcp]:
            lcp += 1
        smaller = lcp + idx == n or (lcp < length and idx + lcp < n
                                     and q[lcp] > codes[idx + lcp])
        return idx, lcp, smaller

    idx, lo_lcp, _ = probe(0)
    if lo_lcp == length:
        return idx, probes, False, events
    idx, hi_lcp, _ = probe(n - 1)
    if hi_lcp == length:
        return idx, probes, False, events
    lo, hi = 0, n - 1
    while True:
        if hi == lo + 1:
            return -1, probes, False, events
        if hi == lo + 2:
            events.append(("base", lo + 1))
            return int(rev[lo + 1]), probes, True, events
        mid = (lo + hi) >> 1
        if lo_lcp >= hi_lcp:
            events.append(("llcp", mid))
            if llcp[mid] > lo_lcp:
                lo = mid
                continue
            if llcp[mid] < lo_lcp:
                hi, hi_lcp = mid, int(llcp[mid])
                continue
        else:
            events.append(("rlcp", mid))
            if rlcp[mid] > hi_lcp:
                hi = mid
                continue
            if rlcp[mid] < hi_lcp:
                lo, lo_lcp = mid, int(rlcp[mid])
                continue
        idx, lcp, smaller = probe(mid)
        if lcp == length:
            return idx, probes, False, events
        if smaller:
            lo, lo_lcp = mid, lcp
        else:
            hi, hi_lcp = mid, lcp


def _sector(t, i):
    """The 32-byte sector number of element i of tensor t."""
    return (t.data_ptr() + i * t.element_size()) >> 5


def _probe_windows(packed, pos, qw, length):
    """The packed genome's sectors a probe at text position pos reads, as
    compare_at reads them (windows of up to 7 query words, each with the
    word after it, indexes clamped to the array, up to the window of the
    first word that differs from the query's): a list of sector lists."""
    wq = -(-length // 16)
    words = packed.numpy()
    last = len(words) - 1
    w0, sh = pos >> 4, (pos & 15) << 1

    def aligned(j):
        w = int(words[min(w0 + j, last)])
        nxt = int(words[min(w0 + j + 1, last)])
        return ((w << sh) & 0xFFFFFFFF) | (nxt >> (32 - sh)) if sh else w

    first = next((j for j in range(wq) if aligned(j) != int(qw[j])), wq)
    windows = []
    for base in range(0, wq, 7):
        nw = min(7, wq - base)
        windows.append(list(range(_sector(packed, min(w0 + base, last)),
                                  _sector(packed, min(w0 + base + nw, last))
                                  + 1)))
        if first < base + nw:
            break
    return windows, first


def _replica_trace(events, packed, nodes, qw, length):
    """The sectors the pruned search reads, in order, for a lane's replica
    events: one node record (one 32-byte sector) a pre-probe, a round or
    the base case, and at L > 32 the genome windows of a probe whose first
    32 bases all agree (compare_at). Returns (trace, genome sectors)."""
    trace, genome = [], 0
    for i, ev in enumerate(events):
        if ev[0] in ("llcp", "rlcp", "base"):
            trace.append(_sector(nodes, 4 * ev[1]))
            continue
        _, rank, pos = ev
        if i < 2:   # a pre-probe reads its record (rank 0, then n - 1)
            trace.append(_sector(nodes, 4 * rank))
        windows, first = _probe_windows(packed, pos, qw, length)
        if length > 32 and first >= 2:
            trace += [s for w in windows for s in w]
            genome += sum(len(w) for w in windows)
    return trace, genome


def _fancy_queries(codes, length, num, seed):
    """In-genome queries with random (mostly absent) ones, poly-A, poly-T,
    genome-tail matches and queries that run off the genome's end: its
    last m < length bases, then pad bases (code 0, as the packed genome's
    and prefix64's padding) or random ones."""
    n = len(codes)
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, max(n - length, 0) + 1, num)
    tiled = np.tile(codes, -(-(length + n) // n))
    q = tiled[starts[:, None] + np.arange(length)].copy()
    q[:40] = rng.integers(0, 4, (40, length))
    q[40:45] = 0
    q[45:50] = 3
    for j, m in enumerate(range(1, min(length, n + 1))):
        if 50 + 2 * j + 1 >= num:
            break
        tail = codes[n - m:]
        q[50 + 2 * j] = np.concatenate([tail, np.zeros(length - m,
                                                       np.uint8)])
        q[51 + 2 * j] = np.concatenate([tail, rng.integers(
            0, 4, length - m).astype(np.uint8)])
    return q


def _mock_nodes(lib, packed, rev, llcp, rlcp, n):
    """The node records through launch_records (the mocked
    records_kernel) on host tensors."""
    return _mock_built(lib, packed, rev, llcp, rlcp, n)


def _kernel_fancy(lib, packed, rev, llcp, rlcp, q_words, n, length):
    """The kernel through launch_fancy on host tensors, with the node
    records of the mocked records kernel (held equal to the plain
    ops.query.fancy_nodes): (positions, int32 [2, B] probes and sectors
    read a lane, the sector trace, the node records), the trace checked to
    hold only sectors of the node records and the packed genome."""
    b = q_words.shape[1]
    nodes = _mock_nodes(lib, packed, rev, llcp, rlcp, n)
    assert nodes.equal(query.fancy_nodes(packed, rev, llcp, rlcp, n=n))
    out = torch.full((b,), -777, dtype=torch.int64)
    lane = torch.full((2, b), -1, dtype=torch.int32)
    depth = torch.zeros(2, dtype=torch.int32)
    trace = torch.full((b, FANCY_TRACE), -5, dtype=torch.int64)
    rc = query_cuda.launch_fancy(lib, None, packed, nodes, q_words, out,
                                 lane, depth, trace, n=n, length=length)
    assert rc == 0
    assert depth.tolist() == [0, 0]
    assert (lane[1] <= FANCY_TRACE).all()
    _check_trace(trace, lane[1], (packed, nodes))
    return out, lane, trace, nodes


def _check_fancy(lib, seq, packed, rev, prefix, codes, length,
                 replica=True):
    """Kernel == fancy_binsearch_batch (with the same prefix) on every
    lane; with `replica`, also == the scalar replica's positions and probe
    counts, and the kernel's sector trace exactly the sectors it reads for
    the replica's reads (_replica_trace: a node record each round, the
    pre-probes and the base case; genome windows only at L > 32 where all
    32 bases tie). Returns the positions and the lanes that read the
    genome."""
    n = len(seq)
    llcp, rlcp = _tables(seq)
    qw_np = packops.pack_queries(codes).astype(np.int64)
    qw = torch.from_numpy(qw_np)
    want = query.fancy_binsearch_batch(packed, rev, llcp, rlcp, qw, n=n,
                                       length=length, prefix=prefix)
    got, lane, trace, nodes = _kernel_fancy(lib, packed, rev, llcp, rlcp,
                                            qw, n, length)
    np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                  err_msg=f"n={n} L={length}")
    if replica:
        gcodes = packops.encode_bases(seq)
        r64 = rev.long().numpy() & 0xFFFFFFFF
        ll, rl = llcp.numpy(), rlcp.numpy()
        genome_lanes = 0
        for i, q in enumerate(codes):
            pos, probes, _base, events = _fancy_replica(gcodes, r64, ll, rl,
                                                        q, n)
            want_trace, genome = _replica_trace(events, packed, nodes,
                                                qw_np[:, i], length)
            genome_lanes += genome > 0
            assert (int(got[i]), int(lane[0, i]), int(lane[1, i])) == (
                pos, probes, len(want_trace)), f"lane {i}, n={n} L={length}"
            assert trace[i, :len(want_trace)].tolist() == want_trace, (
                f"lane {i}, n={n} L={length}")
        return got.numpy(), genome_lanes
    return got.numpy(), None


@pytest.fixture(scope="module")
def dup_genome():
    """A genome with duplications (runs of equal suffixes)."""
    return np.concatenate([repeat_genome(1500, period=37, seed=71),
                           benchmark_genome(6500, seed=72)])


@pytest.mark.parametrize("rev64", [False, True], ids=["rev32", "rev64"])
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_fancy_kernel_source_matches_plain(lib, dup_genome, prefix, rev64):
    """Both probe forms (L = 33 takes the packed one with prefix64 too),
    both rev widths, L = 5, 13, 21, 33: absent, poly-A / poly-T, genome-
    tail and off-the-end queries, against the plain version, the scalar
    replica and its probe counts."""
    idx = _index(dup_genome, 13, 8, prefix_lookup=prefix)
    dev = idx.device_arrays()
    rev = dev["rev"].long() if rev64 else dev["rev"]
    for length in (5, 13, 21, 33):
        codes = _fancy_queries(idx.codes, length, 700, seed=length)
        _check_fancy(lib, dup_genome, dev["packed"], rev, dev["prefix64"],
                     codes, length)


def test_fancy_kernel_source_matches_sapling_tpu(lib, dup_genome):
    """A subset against sapling_tpu's fancy_binsearch_batch, with and
    without prefix64 (the slice held against JAX)."""
    from sapling_tpu.config import IndexConfig as JaxIndexConfig
    from sapling_tpu.index.sapling import SaplingIndex as JaxIndex
    from sapling_tpu.ops.query import fancy_binsearch_batch as jax_fancy

    jidx = JaxIndex.build(dup_genome, JaxIndexConfig(k=13, buckets=8))
    tidx = SaplingIndex.from_arrays(jidx, device="cpu")
    dev = tidx.device_arrays()
    llcp, rlcp = _tables(dup_genome)
    for length in (13, 21, 33):
        codes = _fancy_queries(tidx.codes, length, 400, seed=90 + length)
        qw = packops.pack_queries(codes)
        want = np.asarray(jax_fancy(jidx.packed, jidx.rev, llcp.numpy(),
                                    rlcp.numpy(), qw, n=jidx.n,
                                    length=length, prefix=jidx.prefix64))
        for prefix in (dev["prefix64"], None):
            got, _ = _check_fancy(lib, dup_genome, dev["packed"],
                                  dev["rev"], prefix, codes, length,
                                  replica=False)
            np.testing.assert_array_equal(got, want, err_msg=f"L={length}")


@pytest.mark.parametrize("n", [2, 3, 4, 5, 7, 9, 33, 101, 1001])
def test_fancy_kernel_source_small_genomes(lib, n):
    """Small and odd genome lengths, where the hi == lo + 1 and hi == lo + 2
    base cases fire within a few rounds; periodic genomes (duplicate runs)
    with queries that run off the end; both forms, both rev widths."""
    seq = repeat_genome(n, period=min(5, n), seed=n)
    codes = packops.encode_bases(seq)
    sa = build_suffix_data(seq, np.int32).sa
    packed = torch.from_numpy(
        packops.pack_codes(codes, pad_words=16).astype(np.int64))
    prefix = torch.from_numpy(packops.rank_prefix64(codes, sa).view(np.int64))
    for length in (1, 5, 16, 33):
        q = _fancy_queries(codes, length, 120, seed=n + length)
        for rev in (torch.from_numpy(sa.astype(np.int32)),
                    torch.from_numpy(sa.astype(np.int64))):
            for pre in (prefix, None):
                _check_fancy(lib, seq, packed, rev, pre, q, length)


@pytest.mark.parametrize("rev64", [False, True], ids=["rev32", "rev64"])
@pytest.mark.parametrize("pad", [16, 1, 0])
def test_fancy_nodes_kernel_source(lib, dup_genome, pad, rev64):
    """The node records, plain (ops.query.fancy_nodes) and the mocked
    fancy_nodes_kernel, against rev, llcp | rlcp << 32, a zero word and
    the genome's 32-base keys gathered by rank (each suffix's first 32
    bases, big-endian 2 bits a base, zero past the genome's end). With
    fewer pad words than a key reads past the end (word indexes clamped)
    the two still agree, and their keys equal these on the bases inside
    the genome."""
    seq = dup_genome[:3001]
    n = len(seq)
    codes = packops.encode_bases(seq)
    sa = build_suffix_data(seq, np.int32).sa
    rev = torch.from_numpy(sa.astype(np.int64 if rev64 else np.int32))
    packed = torch.from_numpy(
        packops.pack_codes(codes, pad_words=pad).astype(np.int64))
    llcp, rlcp = _tables(seq)
    plain = query.fancy_nodes(packed, rev, llcp, rlcp, n=n)
    assert plain.equal(_mock_nodes(lib, packed, rev, llcp, rlcp, n))
    ranks = _mock_built(lib, packed, rev, None, None, n)
    assert plain.equal(_mock_built(lib, packed, rev, llcp, rlcp, n, ranks))
    windows = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([codes, np.zeros(32, np.uint8)]), 32)[:n]
    keys = (windows.astype(np.uint64) << (np.uint64(62) - np.uint64(2)
                                          * np.arange(32, dtype=np.uint64))
            ).sum(1, dtype=np.uint64)[sa]
    got = plain.numpy()
    np.testing.assert_array_equal(got[:, 1], sa)
    np.testing.assert_array_equal(
        got[:, 2], llcp.numpy().astype(np.int64)
        | (rlcp.numpy().astype(np.int64) << 32))
    assert (got[:, 3] == 0).all()
    key_bits = got[:, 0].view(np.uint64)
    # the bases inside the genome, 1 to 32 of them
    inside = np.minimum(n - sa.astype(np.int64), 32).astype(np.uint64)
    assert ((key_bits ^ keys) >> (np.uint64(64) - 2 * inside) == 0).all()
    if pad >= 2:   # no clamped word: zero past the end
        np.testing.assert_array_equal(key_bits, keys)


@pytest.mark.parametrize("rev64", [False, True], ids=["rev32", "rev64"])
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
@pytest.mark.parametrize("genome,length", [("dup", 21), ("dup", 40),
                                           ("repeat", 33), ("repeat", 101)])
def test_fancy_kernel_source_off_end_and_ties(lib, dup_genome, genome,
                                              length, prefix, rev64):
    """Queries that run off the genome's end (_fancy_queries) at L = 21
    and 40, and at L = 33 and 101 on a repeat genome, where suffixes share
    their first 32 bases and a probe's node record ties, so the kernel
    reads the genome: against the plain version and the replica
    (positions, probes, the first design's sector trace, the sectors
    read). At L > 32 on the repeat genome some lanes must read the genome;
    on the prefix64 form none does."""
    seq = (dup_genome if genome == "dup"
           else repeat_genome(3000, period=37, seed=77))
    idx = _index(seq, 13, 8, prefix_lookup=prefix)
    dev = idx.device_arrays()
    rev = dev["rev"].long() if rev64 else dev["rev"]
    codes = _fancy_queries(idx.codes, length, 600, seed=length + 500)
    _, genome_lanes = _check_fancy(lib, seq, dev["packed"], rev,
                                   dev["prefix64"], codes, length)
    if genome == "repeat" and length > 32:
        assert genome_lanes > 0
    if prefix and length <= 32:
        assert genome_lanes == 0

