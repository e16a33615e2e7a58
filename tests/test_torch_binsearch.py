"""Parity: the port's binary-search baselines == sapling_tpu's.

`binsearch_batch` (with absent queries, int32 and uint32 rank storage),
`fancy_binsearch_batch` (against JAX's and against the scalar replica of
the reference's fancyBinarySearch in tests/test_fancy.py) and
`SaplingIndex.query_positions_binsearch` return the same positions as the
JAX package, -1s and unverified base-case ranks included.
"""

import numpy as np
import pytest
import torch

from sapling_tpu.config import IndexConfig
from sapling_tpu.index.sapling import SaplingIndex as JaxIndex
from sapling_tpu.index.suffix_array import build_suffix_data
from sapling_tpu.ops.query import binsearch_batch as jax_binsearch
from sapling_tpu.ops.query import fancy_binsearch_batch as jax_fancy
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.index.suffix_array import build_llcp_rlcp
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.ops.query import (binsearch_batch,
                                         fancy_binsearch_batch)
from sapling_tpu_torch.sim.genomes import repeat_genome, uniform_genome

from .test_fancy import _scalar_fancy


def _codes(idx, num, length, seed):
    """In-genome queries, then 1/4 random (mostly absent) ones."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, idx.n - length + 1, num)
    present = idx.codes[starts[:, None] + np.arange(length)]
    absent = rng.integers(0, 4, (num // 4, length)).astype(np.uint8)
    return np.concatenate([present, absent])


@pytest.fixture(scope="module")
def genome():
    return np.concatenate([uniform_genome(20_000, seed=21),
                           repeat_genome(2_000, period=31, seed=22)])


@pytest.mark.parametrize("pos_dtype", ["int32", "uint32"])
def test_binsearch_matches_jax(genome, pos_dtype):
    jidx = JaxIndex.build(genome, IndexConfig(k=13, buckets=8,
                                              pos_dtype=pos_dtype))
    tidx = SaplingIndex.from_arrays(jidx, device="cpu")
    dev = tidx.device_arrays()
    for length in (8, 13, 40):
        codes = _codes(tidx, 400, length, seed=length)
        qw = packops.pack_queries(codes)
        want = np.asarray(jax_binsearch(jidx.packed, jidx.rev, qw,
                                        n=jidx.n, length=length))
        got = binsearch_batch(dev["packed"], dev["rev"],
                              torch.from_numpy(qw.astype(np.int64)),
                              n=tidx.n, length=length).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"L={length}")
        assert tidx.verify_hits(codes[:400], got[:400]).all()
        assert (got[400:] == -1).any()


def test_query_positions_binsearch_matches_jax(genome):
    jidx = JaxIndex.build(genome, IndexConfig(k=13, buckets=8))
    tidx = SaplingIndex.from_arrays(jidx, device="cpu")
    for length in (5, 13, 21):
        codes = _codes(tidx, 300, length, seed=40 + length)
        np.testing.assert_array_equal(
            tidx.query_positions_binsearch(codes),
            np.asarray(jidx.query_positions_binsearch(codes)),
            err_msg=f"L={length}")


def test_fancy_binsearch_matches_jax_and_scalar(genome):
    jidx = JaxIndex.build(genome, IndexConfig(k=13, buckets=8))
    tidx = SaplingIndex.from_arrays(jidx, device="cpu")
    suffix = build_suffix_data(genome)
    llcp, rlcp = build_llcp_rlcp(np.asarray(suffix.lcp, np.int64), tidx.n)
    dev = tidx.device_arrays()
    rev = np.asarray(tidx.rev, np.int64)
    for length in (13, 33):
        codes = _codes(tidx, 300, length, seed=60 + length)
        qw = packops.pack_queries(codes)
        want = np.asarray(jax_fancy(jidx.packed, jidx.rev, llcp, rlcp, qw,
                                    n=jidx.n, length=length))
        got = fancy_binsearch_batch(
            dev["packed"], dev["rev"], torch.from_numpy(llcp),
            torch.from_numpy(rlcp), torch.from_numpy(qw.astype(np.int64)),
            n=tidx.n, length=length).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"L={length}")
        for i in range(0, codes.shape[0], 3):
            assert got[i] == _scalar_fancy(tidx.codes, rev, llcp, rlcp,
                                           codes[i], tidx.n), (length, i)
        np.testing.assert_array_equal(
            tidx.query_positions_fancy(codes, llcp, rlcp), got)
        assert tidx.verify_hits(codes[:300], got[:300]).all()
