"""The index carried across: artifacts and builds agree between packages.

An index built by `sapling_tpu` saves to `.stpu.npz` and loads in
`sapling_tpu_torch` with identical arrays, and the other way round; the
port's own build gives the arrays the JAX package's build gives; and the
cached `from_fasta` artifacts written by either package load in the other.
"""

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
                              IndexConfig(k=k, buckets=buckets))
    theirs = JaxIndex.build(JaxGenome(seq=seq, chr_ends=ends),
                            JaxIndexConfig(k=k, buckets=buckets))
    assert_same_index(ours, theirs)


def test_npz_round_trip_both_ways(genome, tmp_path):
    seq, ends = genome
    jidx = JaxIndex.build(JaxGenome(seq=seq, chr_ends=ends),
                          JaxIndexConfig(k=16))
    jidx.save(str(tmp_path / "jax.stpu.npz"))
    ours = SaplingIndex.load(str(tmp_path / "jax.stpu.npz"))
    assert_same_index(ours, jidx)
    ours.save(str(tmp_path / "torch.stpu.npz"))
    back = JaxIndex.load(str(tmp_path / "torch.stpu.npz"))
    assert_same_index(back, jidx)
    # from_arrays shares the host arrays of any index object
    assert_same_index(SaplingIndex.from_arrays(jidx), jidx)


def test_from_fasta_cache_is_shared(genome, tmp_path):
    """<ref>_k16_b-1.stpu.npz and <ref>.sa written by one package's
    from_fasta load in the other's."""
    seq, ends = genome
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("chrA", bytes(seq[:25_000])),
                     ("chrB", bytes(seq[25_000:]))])
    jidx = JaxIndex.from_fasta(fa, JaxIndexConfig(k=16))
    assert_same_index(SaplingIndex.from_fasta(fa, IndexConfig(k=16)), jidx)
    # a build from the cached .sa alone (no .npz) gives the same index
    (tmp_path / "ref.fa_k16_b-1.stpu.npz").unlink()
    assert_same_index(SaplingIndex.from_fasta(fa, IndexConfig(k=16)), jidx)
    assert_same_index(JaxIndex.load(str(tmp_path / "ref.fa_k16_b-1.stpu.npz")),
                      jidx)


def test_to_leaves_the_index_where_it_was(genome):
    """to(device) gives a view sharing the host arrays; neither it nor an
    aligner built on another device moves the caller's index."""
    seq, ends = genome
    idx = SaplingIndex.build(Genome(seq=seq, chr_ends=ends),
                             IndexConfig(k=16))
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert idx.to("cpu") is idx
    view = idx.to("meta")
    assert view is not idx and view.device == meta and idx.device == cpu
    assert view.packed is idx.packed and view.to("meta") is view
    aligner = SeedExtendAligner(idx, device="meta")
    assert aligner.idx.device == meta and idx.device == cpu
    assert SeedExtendAligner(idx, device="cpu").idx is idx
