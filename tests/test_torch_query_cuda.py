"""The CUDA query kernels on the card (skipped without a GPU).

The kernels (sapling_tpu_torch/csrc/query.cu) have no CPU mode, so these
tests need a CUDA device; here they skip. They import neither jax nor
sapling_tpu, so they run on a machine without JAX, from the repo root:

    python -m pytest --noconftest tests/test_torch_query_cuda.py -q

The reference is the plain PyTorch cascade on the same CUDA tensors
(ops.query.plquery_batch / binsearch_batch / fancy_binsearch_batch, held
against sapling_tpu by tests/test_torch_query*.py and
test_torch_binsearch.py): every position must be equal, -1s and the member
of a duplicate run included, and the kernel's stats must give the plain
path's rounds. tests/test_torch_query_cu_on_cpu.py holds the same source on
the CPU.
"""

import numpy as np
import pytest
import torch

from sapling_tpu_torch.config import IndexConfig, QueryConfig
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.ops import query, query_cuda
from sapling_tpu_torch.ops.predict import predict_pwl
from sapling_tpu_torch.sim.genomes import benchmark_genome, repeat_genome


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _queries(seq, num, length, seed):
    """In-genome substrings plus 1/8 random (mostly absent) queries."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, len(seq) - length + 1, num)
    q = seq[pos[:, None] + np.arange(length)]
    rand = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (max(1, num // 8), length))]
    return packops.encode_bases(np.concatenate([q, rand]))


@pytest.fixture(scope="module")
def seq():
    return np.concatenate([repeat_genome(20_000, period=48, seed=83),
                           benchmark_genome(400_000, seed=84)])


def _index(seq, dev, prefix=True, pos_dtype="auto"):
    idx = SaplingIndex.build(seq, IndexConfig(
        k=21, buckets=14, prefix_lookup=prefix, pos_dtype=pos_dtype),
        keep_aligner_arrays=False, device="cpu")
    return idx.to(dev)


def _call(fn, idx, codes, qcfg=None, pred64=None, fast3=False, **over):
    dev = idx.device_arrays()
    x, q3, q_words = idx.query_inputs(codes, fast3=fast3)
    t = idx.table
    qcfg = qcfg or QueryConfig()
    kw = dict(n=idx.n, length=codes.shape[1], k=idx.k, buckets=idx.buckets,
              most_over=t.most_over, most_under=t.most_under,
              max_over=t.max_over, max_under=t.max_under,
              max_stride_steps=qcfg.max_stride_steps,
              adaptive_bounds=qcfg.adaptive_bounds, pred64=pred64)
    kw.update(over)
    return fn(dev["packed"], dev["rev"], dev["xlist"], dev["ylist"],
              q_words, x, dev["prefix64"], dev["prefix3"], q3, dev["bounds"],
              **kw)


def _same(idx, codes, **kw):
    """Kernel == plain on the card, and the kernel's rounds == the plain
    path's, on the index's record tables (at this size no rank records: a
    probe reads rev and the genome), on rank records made for the test,
    and where the index has prefix3 and the length allows on the fast3
    probe; one launch a call."""
    query.ROUNDS.update(C=0, D=0)
    want = _call(query.plquery_batch, idx, codes, **kw)
    rounds = dict(query.ROUNDS)
    bucket_recs, rank_recs = idx.query_records()
    assert rank_recs is None
    d = idx.device_arrays()
    made = query_cuda.plquery_records_cuda(d["packed"], d["rev"], n=idx.n)
    fast3 = idx.query_inputs(codes, fast3=True)[1] is not None
    for ranks, f3 in ((None, False), (made, False)) + (
            ((None, True),) if fast3 else ()):
        query.ROUNDS.update(C=0, D=0)
        before = dict(query_cuda.LAUNCHES)
        got = _call(query_cuda.plquery_cuda, idx, codes, stats=True,
                    bucket_recs=bucket_recs, rank_recs=ranks, fast3=f3,
                    **kw)
        torch.cuda.synchronize()
        assert query_cuda.LAUNCHES == dict(before,
                                           plquery=before["plquery"] + 1)
        assert torch.equal(got, want), int((got != want).sum())
        assert dict(query.ROUNDS) == rounds
    return got, rounds


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_plquery_kernel_matches_plain(dev, seq, prefix):
    """Every probe form at the reference's lengths, with adaptive bounds,
    and a shifted pred64 with the stride cap."""
    idx = _index(seq, dev, prefix)
    for length in (11, 16, 21, 31, 32, 41, 51, 101, 130):
        codes = _queries(seq, 20_000, length, seed=length)
        got, _ = _same(idx, codes)
        ok = idx.verify_hits(codes, got.cpu().numpy())
        assert length < idx.k or ok[:20_000].all(), length
        _same(idx, codes, qcfg=QueryConfig(adaptive_bounds=True))
        x = torch.from_numpy(idx.kmerize_batch(codes)).to(dev)
        d = idx.device_arrays()
        pred = predict_pwl(x, d["xlist"], d["ylist"], 2 * idx.k,
                           idx.buckets, idx.n)
        rng = np.random.default_rng(length)
        pred = torch.clamp(pred + torch.from_numpy(
            rng.integers(-300, 301, len(codes))).to(dev), 0, idx.n - 1)
        _, rounds = _same(idx, codes, pred64=pred)
        assert (rounds["C"] > 0) == (length > idx.k), rounds
        _same(idx, codes, pred64=pred, max_stride_steps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("pos_dtype", ["uint32", "int64"])
def test_plquery_kernel_rank_storage(dev, seq, pos_dtype):
    idx = _index(seq, dev, pos_dtype=pos_dtype)
    want = torch.int64 if pos_dtype == "int64" else torch.int32
    assert idx.device_arrays()["rev"].dtype == want
    for length in (21, 45):
        _same(idx, _queries(seq, 20_000, length, seed=3))


@pytest.mark.cuda
@pytest.mark.parametrize("pos_dtype", ["uint32", "int64"])
def test_record_kernels_match_plain(dev, seq, pos_dtype):
    """plquery's record tables on the card (bucket_records_cuda,
    plquery_records_cuda) equal to the plain ops.query.bucket_records /
    plquery_records on the same CUDA tensors, one launch each: the
    index's, a packed genome without pad words, the host's 32-bit words,
    and checkpoints whose
    buckets rise by 2^32 - 2 (in the record), 2^32 - 1 and past, or fall,
    with bounds words 0xFFFFFFFF and 0; a query without the records makes
    the bucket records first (two launches; rank records only past the
    card's L2, ops.query_cuda.reads_rank_records)."""
    idx = _index(seq, dev, pos_dtype=pos_dtype)
    d = idx.device_arrays()
    unpadded = torch.from_numpy(packops.pack_codes(
        idx.codes, pad_words=0).astype(np.int64)).to(dev)
    host32 = torch.from_numpy(idx.packed.view(np.int32)).to(dev)
    for packed, words in ((d["packed"], d["packed"]), (unpadded, unpadded),
                          (d["packed"], host32)):
        before = query_cuda.LAUNCHES["plquery_records"]
        got = query_cuda.plquery_records_cuda(words, d["rev"], n=idx.n)
        assert query_cuda.LAUNCHES["plquery_records"] == before + 1
        assert torch.equal(got, query.plquery_records(packed, d["rev"],
                                                      n=idx.n))
    ylist = d["ylist"].clone()
    ylist[1::4] += (1 << 32) - 2
    ylist[2::4] += (1 << 32) - 1
    ylist[3::4] -= 1 << 40
    bounds = d["bounds"].clone()
    bounds[::2] = -1
    bounds[1::4] = 0
    for b in (bounds, None):
        got = query_cuda.bucket_records_cuda(d["xlist"], ylist, b,
                                             buckets=idx.buckets)
        want = query.bucket_records(d["xlist"], ylist, b,
                                    buckets=idx.buckets)
        assert got.shape == (1 << idx.buckets, 4) and torch.equal(got, want)
    assert int(((want[:, 3] & 0xFFFFFFFF) == query.WIDE_M).sum()) > 1000
    codes = _queries(seq, 5000, 33, seed=12)
    before = dict(query_cuda.LAUNCHES)
    got = _call(query_cuda.plquery_cuda, idx, codes)
    assert query_cuda.LAUNCHES == {k: v + (k in ("plquery", "bucket_records"))
                                   for k, v in before.items()}
    assert torch.equal(got, _call(query.plquery_batch, idx, codes))


@pytest.mark.cuda
def test_rank_records_past_the_l2(dev, seq, monkeypatch):
    """Where reads_rank_records says so (here forced, as past the card's
    L2), the index makes rank records once (one more launch on its first
    query) and the kernel reads them: equal to the plain cascade at every
    probe form."""
    monkeypatch.setattr(query_cuda, "reads_rank_records", lambda rev, p: True)
    from sapling_tpu_torch.index import sapling
    monkeypatch.setattr(sapling, "reads_rank_records", lambda rev, p: True)
    idx = _index(seq, dev, prefix=False)
    before = dict(query_cuda.LAUNCHES)
    bucket, rank = idx.query_records()
    assert rank.shape == (idx.n, 2)
    assert query_cuda.LAUNCHES == {k: v + (k in ("bucket_records",
                                                 "plquery_records"))
                                   for k, v in before.items()}
    for length in (16, 33, 101):
        codes = _queries(seq, 20_000, length, seed=20 + length)
        got = idx.query_device(*idx.query_inputs(codes), length)
        assert torch.equal(got, _call(query.plquery_batch, idx, codes))
    assert query_cuda.LAUNCHES["plquery_records"] == before[
        "plquery_records"] + 1


@pytest.mark.cuda
def test_swap_table_rebuilds_the_bucket_records(dev, seq):
    """swap_table on an index whose record tables exist: the bucket records
    made anew of the new table (one launch), the rank records kept, and the
    positions after the swap equal to an index built with that table."""
    idx = _index(seq, dev)
    other = SaplingIndex.build(seq, IndexConfig(k=21, buckets=12),
                               keep_aligner_arrays=False, device="cpu")
    codes = _queries(seq, 20_000, 21, seed=13)
    idx.query_device(*idx.query_inputs(codes), 21)
    bucket, rank = idx.query_records()
    before = dict(query_cuda.LAUNCHES)
    idx.swap_table(other.table)
    assert query_cuda.LAUNCHES == dict(
        before, bucket_records=before["bucket_records"] + 1)
    bucket2, rank2 = idx.query_records()
    assert rank2 is rank and bucket2.shape == (1 << 12, 4)
    got = idx.query_positions(codes)
    np.testing.assert_array_equal(got, other.query_positions(codes))
    assert query_cuda.LAUNCHES["bucket_records"] == before[
        "bucket_records"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("pos_dtype", ["int32", "int64"])
def test_binsearch_kernel_matches_plain(dev, seq, pos_dtype):
    idx = _index(seq, dev, pos_dtype=pos_dtype)
    d = idx.device_arrays()
    for length in (11, 21, 101):
        qw = idx.query_words(_queries(seq, 20_000, length, seed=5))
        query.ROUNDS.update(C=0, D=0)
        want = query.binsearch_batch(d["packed"], d["rev"], qw, n=idx.n,
                                     length=length)
        rounds = dict(query.ROUNDS)
        query.ROUNDS.update(C=0, D=0)
        got = query_cuda.binsearch_cuda(d["packed"], d["rev"], qw, n=idx.n,
                                        length=length, stats=True)
        assert torch.equal(got, want)
        assert dict(query.ROUNDS) == rounds
        assert idx.binsearch_device(qw, length).equal(want)


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_kernels_on_shuffled_batches(dev, seq, prefix):
    """Hits and misses in a seeded random order over many of plquery's
    warp chunks (112,500 lanes: the last chunk partial), at every probe
    form, as built and with adaptive bounds, and the binary search with its
    shared table: every lane equal to the plain cascade."""
    idx = _index(seq, dev, prefix)
    d = idx.device_arrays()
    rng = np.random.default_rng(31)
    for length in (21, 31, 101):
        codes = _queries(seq, 100_000, length, seed=length)
        codes = codes[rng.permutation(len(codes))]
        _same(idx, codes)
        _same(idx, codes, qcfg=QueryConfig(adaptive_bounds=True))
        qw = idx.query_words(codes)
        query.ROUNDS.update(C=0, D=0)
        want = query.binsearch_batch(d["packed"], d["rev"], qw, n=idx.n,
                                     length=length)
        rounds = dict(query.ROUNDS)
        query.ROUNDS.update(C=0, D=0)
        got = query_cuda.binsearch_cuda(d["packed"], d["rev"], qw, n=idx.n,
                                        length=length, stats=True)
        assert torch.equal(got, want), int((got != want).sum())
        assert dict(query.ROUNDS) == rounds


@pytest.mark.cuda
def test_binsearch_kernel_small_genomes(dev):
    """The binary search's shared table at genome lengths whose bisection
    has fewer levels than the table, about as many, and more (periodic
    genomes: duplicate runs, ties on the table's 32-base key)."""
    from sapling_tpu_torch.index.suffix_array import build_suffix_data

    for n in (2, 5, 33, 1000, 4095, 4097, 9000):
        seq = repeat_genome(n, period=min(7, n), seed=n)
        codes = packops.encode_bases(seq)
        rev = torch.from_numpy(build_suffix_data(seq, np.int32).sa).to(dev)
        packed = torch.from_numpy(packops.pack_codes(
            codes, pad_words=16).astype(np.int64)).to(dev)
        rng = np.random.default_rng(n)
        for length in (5, 32, 33, 101):
            tiled = np.tile(codes, -(-(length + n) // n))
            q = tiled[rng.integers(0, n, 3000)[:, None] + np.arange(length)]
            q[:500] = rng.integers(0, 4, (500, length))
            qw = torch.from_numpy(
                packops.pack_queries(q).astype(np.int64)).to(dev)
            want = query.binsearch_batch(packed, rev, qw, n=n, length=length)
            got = query_cuda.binsearch_cuda(packed, rev, qw, n=n,
                                            length=length)
            assert torch.equal(got, want), (n, length)


@pytest.fixture(scope="module")
def tables(seq):
    """The genome's int32 llcp / rlcp tables (host tensors)."""
    from sapling_tpu_torch.index.suffix_array import (build_llcp_rlcp,
                                                      build_suffix_data)

    lcp = np.asarray(build_suffix_data(seq).lcp, np.int64)
    return tuple(torch.from_numpy(a) for a in build_llcp_rlcp(lcp,
                                                              len(seq)))


def _off_end(seq, length, num, seed):
    """Queries that run off the genome's end: its last m < length bases,
    then pad bases (A, code 0) or random ones."""
    rng = np.random.default_rng(seed)
    m = rng.integers(1, max(2, min(length, len(seq) + 1)), num)
    q = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (num, length))]
    q[::2] = ord("A")
    for i, mi in enumerate(m):
        q[i, :mi] = seq[len(seq) - mi:]
    return packops.encode_bases(q)


@pytest.mark.cuda
@pytest.mark.parametrize("pos_dtype", ["uint32", "int64"])
@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_fancy_kernel_matches_plain(dev, seq, tables, prefix, pos_dtype):
    """The llcp/rlcp-pruned search at lengths 5-130 (the prefix64 probe up
    to 32 bases), in-genome, absent and off-the-end queries, shuffled,
    on node records built once: every lane equal to the plain version on
    the same CUDA tensors, one launch a call, and binsearch_device runs
    it (building its own records once)."""
    idx = _index(seq, dev, prefix, pos_dtype=pos_dtype)
    d = idx.device_arrays()
    llcp, rlcp = (t.to(dev) for t in tables)
    nodes = query_cuda.fancy_nodes_cuda(d["packed"], d["rev"], llcp, rlcp,
                                        n=idx.n)
    rng = np.random.default_rng(41)
    for length in (5, 13, 21, 32, 33, 101, 130):
        codes = np.concatenate([_queries(seq, 20_000, length, seed=length),
                                _off_end(seq, length, 2000, seed=length)])
        qw = idx.query_words(codes[rng.permutation(len(codes))])
        want = query.fancy_binsearch_batch(
            d["packed"], d["rev"], llcp, rlcp, qw, n=idx.n, length=length,
            prefix=d["prefix64"])
        before = dict(query_cuda.LAUNCHES)
        query.ROUNDS.update(C=0, D=0)
        got = query_cuda.fancy_binsearch_cuda(
            d["packed"], d["rev"], llcp, rlcp, qw, n=idx.n, length=length,
            prefix=d["prefix64"], nodes=nodes, stats=True)
        torch.cuda.synchronize()
        assert query_cuda.LAUNCHES == dict(before, fancy=before["fancy"] + 1)
        assert torch.equal(got, want), (length, int((got != want).sum()))
        assert dict(query.ROUNDS) == {"C": 0, "D": 0}
        # a node record a pre-probe, a round or the base case; the genome
        # only past 32 bases
        reads = query_cuda.LAST_STATS["sectors"]
        assert (reads >= 1).all()
        if length <= 32:
            assert (reads <= (idx.n - 1).bit_length() + 5).all()
        assert idx.binsearch_device(qw, length, llcp, rlcp).equal(want)


@pytest.mark.cuda
@pytest.mark.parametrize("pos_dtype", ["uint32", "int64"])
def test_fancy_nodes_kernel_matches_plain(dev, seq, tables, pos_dtype):
    """The node records: records_kernel equal to the plain
    ops.query.fancy_nodes on the same CUDA tensors, both rev widths, also
    on a packed genome without pad words (word indexes clamped) and from
    the host's 32-bit words; one launch a call."""
    idx = _index(seq, dev, pos_dtype=pos_dtype)
    d = idx.device_arrays()
    llcp, rlcp = (t.to(dev) for t in tables)
    unpadded = torch.from_numpy(packops.pack_codes(
        idx.codes, pad_words=0).astype(np.int64)).to(dev)
    host32 = torch.from_numpy(idx.packed.view(np.int32)).to(dev)
    for packed, words in ((d["packed"], d["packed"]), (unpadded, unpadded),
                          (d["packed"], host32)):
        before = query_cuda.LAUNCHES["fancy_nodes"]
        got = query_cuda.fancy_nodes_cuda(words, d["rev"], llcp, rlcp,
                                          n=idx.n)
        assert query_cuda.LAUNCHES["fancy_nodes"] == before + 1
        want = query.fancy_nodes(packed, d["rev"], llcp, rlcp, n=idx.n)
        assert got.shape == (idx.n, 4) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pos_dtype", ["uint32", "int64"])
def test_fancy_nodes_from_rank_records(dev, seq, tables, pos_dtype,
                                       monkeypatch):
    """Node records whose first halves are copied from the index's rank
    records (fancy_nodes_cuda with rank_recs; SaplingIndex.fancy_nodes
    where query_records made them and the genome outgrows the L2, both
    here forced): equal to the plain version, one launch, and the pruned
    search on them equal to the plain search."""
    from sapling_tpu_torch.index import sapling
    for mod in (query_cuda, sapling):
        monkeypatch.setattr(mod, "reads_rank_records", lambda rev, p: True)
    monkeypatch.setattr(sapling, "copies_rank_records", lambda p: True)
    idx = _index(seq, dev, pos_dtype=pos_dtype)
    d = idx.device_arrays()
    llcp, rlcp = (t.to(dev) for t in tables)
    _bucket, ranks = idx.query_records()
    want = query.fancy_nodes(d["packed"], d["rev"], llcp, rlcp, n=idx.n)
    before = query_cuda.LAUNCHES["fancy_nodes"]
    got = query_cuda.fancy_nodes_cuda(d["packed"], d["rev"], llcp, rlcp,
                                      n=idx.n, rank_recs=ranks)
    assert query_cuda.LAUNCHES["fancy_nodes"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(idx.fancy_nodes(llcp, rlcp), want)
    codes = _queries(seq, 20_000, 33, seed=61)
    qw = idx.query_words(codes)
    assert torch.equal(idx.binsearch_device(qw, 33, llcp, rlcp),
                       query.fancy_binsearch_batch(
                           d["packed"], d["rev"], llcp, rlcp, qw, n=idx.n,
                           length=33, prefix=d["prefix64"]))


@pytest.mark.cuda
def test_fancy_kernel_small_genomes(dev):
    """Small and odd genome lengths (the base cases within a few rounds),
    periodic genomes, both probe forms."""
    from sapling_tpu_torch.index.suffix_array import (build_llcp_rlcp,
                                                      build_suffix_data)

    for n in (2, 3, 5, 33, 1001, 9000):
        seq = repeat_genome(n, period=min(5, n), seed=n)
        codes = packops.encode_bases(seq)
        sd = build_suffix_data(seq, np.int32)
        rev = torch.from_numpy(sd.sa).to(dev)
        llcp, rlcp = (torch.from_numpy(a).to(dev) for a in build_llcp_rlcp(
            np.asarray(sd.lcp, np.int64), n))
        packed = torch.from_numpy(packops.pack_codes(
            codes, pad_words=16).astype(np.int64)).to(dev)
        prefix = torch.from_numpy(packops.rank_prefix64(
            codes, sd.sa).view(np.int64)).to(dev)
        rng = np.random.default_rng(n)
        for length in (1, 5, 32, 33, 101):
            tiled = np.tile(codes, -(-(length + n) // n))
            q = tiled[rng.integers(0, n, 3000)[:, None] + np.arange(length)]
            q[:500] = rng.integers(0, 4, (500, length))
            q = np.concatenate([q, _off_end(seq, length, 500, seed=n)])
            qw = torch.from_numpy(
                packops.pack_queries(q).astype(np.int64)).to(dev)
            for pre in (prefix, None):
                want = query.fancy_binsearch_batch(
                    packed, rev, llcp, rlcp, qw, n=n, length=length,
                    prefix=pre)
                got = query_cuda.fancy_binsearch_cuda(
                    packed, rev, llcp, rlcp, qw, n=n, length=length,
                    prefix=pre)
                assert torch.equal(got, want), (n, length)


@pytest.mark.cuda
def test_entry_points_launch_the_kernels(dev, seq, tables):
    """SaplingIndex.query_device and binsearch_device (both searches)
    launch once a call, plquery's bucket records once for the index (on
    its first query; no rank records at this size), the pruned search's
    node records once for a pair of tables (again after a table is written
    in place); an empty batch launches nothing."""
    idx = _index(seq, dev)
    codes = _queries(seq, 1000, 21, seed=8)
    llcp, rlcp = (t.to(dev) for t in tables)
    before = dict(query_cuda.LAUNCHES)
    idx.query_device(*idx.query_inputs(codes), 21)
    idx.binsearch_device(idx.query_words(codes), 21)
    want = idx.binsearch_device(idx.query_words(codes), 21, llcp, rlcp)
    idx.query_device(*idx.query_inputs(codes[:0]), 21)
    torch.cuda.synchronize()
    assert query_cuda.LAUNCHES == {k: v + (k != "plquery_records")
                                   for k, v in before.items()}
    got = idx.binsearch_device(idx.query_words(codes), 21, llcp, rlcp)
    assert torch.equal(got, want)
    assert query_cuda.LAUNCHES["fancy"] == before["fancy"] + 2
    assert query_cuda.LAUNCHES["fancy_nodes"] == before["fancy_nodes"] + 1
    llcp.add_(0)
    idx.binsearch_device(idx.query_words(codes), 21, llcp, rlcp)
    assert query_cuda.LAUNCHES["fancy_nodes"] == before["fancy_nodes"] + 2


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(dev, seq, tables):
    idx = _index(seq, dev)
    codes = _queries(seq, 100, 33, seed=2)
    d = idx.device_arrays()
    x, _q3, qw = idx.query_inputs(codes)
    with pytest.raises(ValueError):                      # device
        _call(query_cuda.plquery_cuda, idx, codes, pred64=torch.zeros(
            len(codes), dtype=torch.int64))
    with pytest.raises(ValueError):                      # dtype
        query_cuda.binsearch_cuda(d["packed"], d["rev"], qw.int(), n=idx.n,
                                  length=33)
    with pytest.raises(ValueError):                      # layout
        query_cuda.binsearch_cuda(d["packed"], d["rev"], qw.t().contiguous()
                                  .t(), n=idx.n, length=33)
    with pytest.raises(ValueError):                      # short rev
        query_cuda.binsearch_cuda(d["packed"], d["rev"][:10], qw, n=idx.n,
                                  length=33)
    with pytest.raises(ValueError):                      # no bounds
        query_cuda.plquery_cuda(
            d["packed"], d["rev"], d["xlist"], d["ylist"], qw, x, n=idx.n,
            length=33, k=idx.k, buckets=idx.buckets, most_over=1,
            most_under=1, max_over=2, max_under=2, adaptive_bounds=True)
    llcp, rlcp = tables
    with pytest.raises(ValueError):                      # tables' dtype
        query_cuda.fancy_binsearch_cuda(
            d["packed"], d["rev"], llcp.to(dev).long(), rlcp.to(dev), qw,
            n=idx.n, length=33)
    with pytest.raises(ValueError):                      # tables' device
        query_cuda.fancy_binsearch_cuda(d["packed"], d["rev"], llcp, rlcp,
                                        qw, n=idx.n, length=33)
    with pytest.raises(ValueError):                      # n past int32
        query_cuda.fancy_binsearch_cuda(
            d["packed"], d["rev"], llcp.to(dev), rlcp.to(dev), qw,
            n=1 << 31, length=33)
    llcp, rlcp = llcp.to(dev), rlcp.to(dev)
    nodes = query_cuda.fancy_nodes_cuda(d["packed"], d["rev"], llcp, rlcp,
                                        n=idx.n)
    with pytest.raises(ValueError):                      # records' shape
        query_cuda.fancy_binsearch_cuda(d["packed"], d["rev"], llcp, rlcp,
                                        qw, n=idx.n, length=33,
                                        nodes=nodes[:-1])
    shifted = torch.empty(4 * idx.n + 1, dtype=torch.int64,
                          device=dev)[1:].view(idx.n, 4)
    with pytest.raises(ValueError):                      # records' sector
        query_cuda.fancy_binsearch_cuda(d["packed"], d["rev"], llcp, rlcp,
                                        qw, n=idx.n, length=33,
                                        nodes=shifted)
    bucket = idx.query_records()[0]
    rank = query_cuda.plquery_records_cuda(d["packed"], d["rev"], n=idx.n)
    kw = dict(n=idx.n, length=33, k=idx.k, buckets=idx.buckets,
              most_over=1, most_under=1, max_over=2, max_under=2)
    args = (d["packed"], d["rev"], d["xlist"], d["ylist"], qw, x)
    for bad in (dict(bucket_recs=bucket[:-1], rank_recs=rank),
                dict(bucket_recs=bucket, rank_recs=rank[:-1]),
                dict(bucket_recs=bucket.int(), rank_recs=rank)):
        with pytest.raises(ValueError):                  # records' shape
            query_cuda.plquery_cuda(*args, **bad, **kw)
    off16 = torch.empty(4 * len(bucket) + 2, dtype=torch.int64,
                        device=dev)[2:].view(-1, 4)
    off8 = torch.empty(2 * idx.n + 1, dtype=torch.int64,
                       device=dev)[1:].view(idx.n, 2)
    for bad in (dict(bucket_recs=off16, rank_recs=rank),
                dict(bucket_recs=bucket, rank_recs=off8)):
        with pytest.raises(ValueError):                  # records' alignment
            query_cuda.plquery_cuda(*args, **bad, **kw)
