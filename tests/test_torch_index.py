"""The index carried across: artifacts and builds agree between packages.

An index built by `sapling_tpu` saves to `.stpu.npz` and loads in
`sapling_tpu_torch` with identical arrays, and the other way round; the
port's own build gives the arrays the JAX package's build gives; and the
cached `from_fasta` artifacts written by either package load in the other.
"""

import inspect
import os
import sys

import numpy as np
import pytest
import torch

from sapling_tpu.config import IndexConfig as JaxIndexConfig
from sapling_tpu.index.sapling import SaplingIndex as JaxIndex
from sapling_tpu.io.fasta import Genome as JaxGenome
from sapling_tpu_torch.align.aligner import SeedExtendAligner
from sapling_tpu_torch.config import IndexConfig
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.io.fasta import Genome, write_fasta
from sapling_tpu_torch.sim.genomes import benchmark_genome

from .test_torch_query_cu_on_cpu import lib  # noqa: F401  (the fixture)

ARRAYS = ("packed", "rev", "inv", "codes", "prefix64", "prefix3",
          "lcpk_fwd", "lcpk_bwd", "rev_hi", "inv_hi")
SCALARS = ("n", "k", "buckets", "chr_ends")
TABLE = ("buckets", "max_over", "max_under", "mean_error", "most_over",
         "most_under")


def assert_same_index(a, b):
    for f in SCALARS:
        assert getattr(a, f) == getattr(b, f), f
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    for f in TABLE:
        assert getattr(a.table, f) == getattr(b.table, f), f
    for f in ("xlist", "ylist", "bounds"):
        np.testing.assert_array_equal(getattr(a.table, f),
                                      getattr(b.table, f), err_msg=f)


@pytest.fixture(scope="module")
def genome():
    seq = benchmark_genome(40_000, seed=23)
    return seq, [(25_000, "chrA"), (40_000, "chrB")]


@pytest.mark.parametrize("k,buckets", [(16, -1), (21, 12)])
def test_build_matches_jax(genome, k, buckets):
    seq, ends = genome
    ours = SaplingIndex.build(Genome(seq=seq, chr_ends=ends),
                              IndexConfig(k=k, buckets=buckets), device="cpu")
    theirs = JaxIndex.build(JaxGenome(seq=seq, chr_ends=ends),
                            JaxIndexConfig(k=k, buckets=buckets))
    assert_same_index(ours, theirs)


def test_npz_round_trip_both_ways(genome, tmp_path):
    seq, ends = genome
    jidx = JaxIndex.build(JaxGenome(seq=seq, chr_ends=ends),
                          JaxIndexConfig(k=16))
    jidx.save(str(tmp_path / "jax.stpu.npz"))
    ours = SaplingIndex.load(str(tmp_path / "jax.stpu.npz"), device="cpu")
    assert_same_index(ours, jidx)
    ours.save(str(tmp_path / "torch.stpu.npz"))
    back = JaxIndex.load(str(tmp_path / "torch.stpu.npz"))
    assert_same_index(back, jidx)
    # from_arrays shares the host arrays of any index object
    assert_same_index(SaplingIndex.from_arrays(jidx, device="cpu"), jidx)


def test_from_fasta_cache_is_shared(genome, tmp_path):
    """<ref>_k16_b-1.stpu.npz and <ref>.sa written by one package's
    from_fasta load in the other's."""
    seq, ends = genome
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("chrA", bytes(seq[:25_000])),
                     ("chrB", bytes(seq[25_000:]))])
    jidx = JaxIndex.from_fasta(fa, JaxIndexConfig(k=16))
    assert_same_index(SaplingIndex.from_fasta(fa, IndexConfig(k=16),
                                              device="cpu"), jidx)
    # a build from the cached .sa alone (no .npz) gives the same index
    (tmp_path / "ref.fa_k16_b-1.stpu.npz").unlink()
    assert_same_index(SaplingIndex.from_fasta(fa, IndexConfig(k=16),
                                              device="cpu"), jidx)
    assert_same_index(JaxIndex.load(str(tmp_path / "ref.fa_k16_b-1.stpu.npz")),
                      jidx)


def test_split_limb_artifact_answers_as_jax(tmp_path):
    """A format-v4 artifact (split-limb rev, no prefix arrays) from
    tools/build_big_index.build_split, as tests/test_bigsplit.py makes
    it: the port reassembles rev into int64 and answers the general path
    and the binary search exactly as JAX's SplitRanks layout does."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from build_big_index import build_split

    n, k, nb = 400_000, 21, 10
    out = str(tmp_path / "big.stpu.npz")
    build_split(n, k, nb, workers=2, out=out)
    jidx = JaxIndex.load(out)
    tidx = SaplingIndex.load(out, device="cpu")
    assert tidx.rev_hi is not None and tidx.prefix3 is None
    rev = tidx.device_arrays()["rev"]
    assert rev.dtype == torch.int64
    np.testing.assert_array_equal(rev.numpy(), jidx.rev.astype(np.int64))
    rng = np.random.default_rng(0)
    for length in (16, 21, 31):
        starts = rng.integers(0, n - length, 1500)
        codes = tidx.codes[starts[:, None] + np.arange(length)]
        codes[:100] = rng.integers(0, 4, (100, length))
        got = tidx.query_positions(codes)
        np.testing.assert_array_equal(got, np.asarray(
            jidx.query_positions(codes)), err_msg=f"L={length}")
        assert tidx.verify_hits(codes[100:], got[100:]).all()
    np.testing.assert_array_equal(
        tidx.query_positions_binsearch(codes),
        np.asarray(jidx.query_positions_binsearch(codes)))


def test_cuda_index_without_a_gpu_raises(genome):
    """No fallback: an index put on "cuda" where there is no GPU raises
    instead of answering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    seq, ends = genome
    idx = SaplingIndex.build(Genome(seq=seq, chr_ends=ends),
                             IndexConfig(k=16), keep_aligner_arrays=False,
                             device="cpu")
    codes = idx.codes[np.arange(8)[:, None] + np.arange(16)]
    with pytest.raises((AssertionError, RuntimeError)):
        idx.to("cuda").query_positions(codes)


def test_to_leaves_the_index_where_it_was(genome):
    """to(device) gives a view sharing the host arrays; neither it nor an
    aligner built on another device moves the caller's index."""
    seq, ends = genome
    idx = SaplingIndex.build(Genome(seq=seq, chr_ends=ends),
                             IndexConfig(k=16), device="cpu")
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert idx.to("cpu") is idx
    view = idx.to("meta")
    assert view is not idx and view.device == meta and idx.device == cpu
    assert view.packed is idx.packed and view.to("meta") is view
    aligner = SeedExtendAligner(idx, device="meta")
    assert aligner.idx.device == meta and idx.device == cpu
    assert SeedExtendAligner(idx, device="cpu").idx is idx


def test_entry_points_default_to_the_card(genome, tmp_path):
    """Every entry point of the port defaults to "cuda", and with no GPU a
    query through a default index, aligner or CLI twin raises instead of
    running on the CPU."""
    from sapling_tpu_torch.tools import align, binarysearch, sapling_example

    cuda = torch.device("cuda")
    for fn in (SaplingIndex.build, SaplingIndex.from_arrays,
               SaplingIndex.load, SaplingIndex.from_fasta,
               SeedExtendAligner.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    seq, ends = genome
    idx = SaplingIndex.build(Genome(seq=seq, chr_ends=ends),
                             IndexConfig(k=16))
    assert idx.device == cuda
    assert SeedExtendAligner(idx).idx.device == cuda
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults run there")
    no_gpu = (AssertionError, RuntimeError)
    codes = idx.codes[np.arange(8)[:, None] + np.arange(16)]
    with pytest.raises(no_gpu):
        idx.query_positions(codes)
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("chrA", bytes(seq[:20_000]))])
    fq = str(tmp_path / "reads.fq")
    with open(fq, "w") as f:
        f.write("@r0\n" + bytes(b"ACGT"[c] for c in idx.codes[:100]).decode()
                + "\n+\n" + "I" * 100 + "\n")
    with pytest.raises(no_gpu):
        align.main(["align", fq, fa, str(tmp_path / "out.sam")])
    with pytest.raises(no_gpu):
        binarysearch.main(["binarysearch", fa, "nq=50", "qLen=16"])
    with pytest.raises(no_gpu):
        sapling_example.main(["sapling_example", fa, "k=16", "nb=8",
                              "nq=50", "qLen=16"])


def test_swap_table_rebuilds_the_bucket_records(genome, monkeypatch, lib):
    """plquery's record tables of an index that stands as if on the card
    (its device arrays host tensors, so the record builders take their
    plain versions): made on the first query_records call and kept;
    swap_table makes the bucket records anew of the new table (its bucket
    count and bounds) and keeps the rank records; device_bytes counts
    both. The mocked plquery kernel on the records after the swap equals
    the plain cascade on the swapped arrays and an index built with that
    table, on every lane."""
    from sapling_tpu_torch.index import sapling
    from sapling_tpu_torch.ops import query, query_cuda

    from .test_torch_query_cu_on_cpu import _kw

    seq, ends = genome
    g = Genome(seq=seq, chr_ends=ends)
    idx = SaplingIndex.build(g, IndexConfig(k=21, buckets=10), device="cpu")
    other = SaplingIndex.build(g, IndexConfig(k=21, buckets=8),
                               keep_aligner_arrays=False, device="cpu")
    monkeypatch.setattr(idx, "device", torch.device("cuda"))
    monkeypatch.setattr(SaplingIndex, "_put",
                        lambda self, a: torch.from_numpy(np.array(a)))
    monkeypatch.setattr(sapling, "reads_rank_records", lambda rev, pk: True)
    bucket, rank = idx.query_records()
    assert idx.query_records() == (bucket, rank)
    assert bucket.shape == (1 << 10, 4) and rank.shape == (idx.n, 2)
    idx.swap_table(other.table)
    assert idx._records["bucket"] is not bucket
    bucket, rank2 = idx.query_records()
    assert rank2 is rank
    dev = idx.device_arrays()
    assert bucket.equal(query.bucket_records(
        dev["xlist"], dev["ylist"], dev["bounds"], buckets=8))
    assert bucket.shape == (1 << 8, 4)
    assert idx.device_bytes() == sum(
        t.numel() * t.element_size()
        for t in (*dev.values(), bucket, rank) if t is not None)
    rng = np.random.default_rng(8)
    for length, adaptive in ((21, False), (21, True), (45, False)):
        starts = rng.integers(0, idx.n - length, 1500)
        codes = idx.codes[starts[:, None] + np.arange(length)]
        x, q3, _ = other.query_inputs(codes)   # on the CPU
        args = (dev["packed"], dev["rev"], dev["xlist"], dev["ylist"],
                other.query_words(codes), x, dev["prefix64"],
                dev["prefix3"], q3, dev["bounds"])
        kw = _kw(idx, length, adaptive_bounds=adaptive)
        out = torch.empty(len(codes), dtype=torch.int64)
        assert query_cuda.launch_plquery(
            lib, None, *args[:6], None, None, args[9], None, out, None, None,
            None, bucket_recs=bucket, rank_recs=rank, **kw) == 0
        want = query.plquery_batch(*args, **kw)
        np.testing.assert_array_equal(out.numpy(), want.numpy())
        if not adaptive:
            np.testing.assert_array_equal(out.numpy(),
                                          other.query_positions(codes))
