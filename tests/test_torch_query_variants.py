"""Parity of the plquery options: the port == sapling_tpu, bit for bit.

Boundary queries (poly-A, poly-T, genome tails, absent) through every
probe form, adaptive bounds, a foreign prediction through the pred64
seam, the phase C stride cap and uint32 rank storage, each against the
JAX package on the same seeded inputs.
"""

import numpy as np
import pytest
import torch

from sapling_tpu.config import QueryConfig as JaxQueryConfig
from sapling_tpu.ops.query import plquery_batch as jax_plquery
from sapling_tpu_torch.config import QueryConfig
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.ops.predict import predict_pwl
from sapling_tpu_torch.ops.query import plquery_batch
from sapling_tpu_torch.sim.genomes import benchmark_genome, repeat_genome

from .test_torch_query import _pair, _queries


def _boundary_queries(idx, length, num, seed):
    """In-genome queries with absent ones, poly-A and poly-T (rank 0 and
    rank n-1 predictions) and genome-tail matches (short-suffix pads);
    tests/test_query.py's prefix-probe mix."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, idx.n - length + 1, num)
    codes = idx.codes[starts[:, None] + np.arange(length)]
    codes[:60] = rng.integers(0, 4, (60, length))
    codes[60:70] = 0
    codes[70:80] = 3
    for j in range(80, 90):
        s = idx.n - length - (j - 80)
        codes[j] = idx.codes[s:s + length]
    return codes



@pytest.fixture(scope="module")
def k21_pair():
    """One k=21 index with duplications for the variants below."""
    seq = np.concatenate([repeat_genome(3000, period=48, seed=83),
                          benchmark_genome(27_000, seed=84)])
    return _pair(seq, 21, 9)


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "packed"])
def test_boundary_queries_parity(k21_pair, prefix):
    """Poly-A, poly-T, genome-tail and absent queries at lengths through
    every probe form (fast3 11/21, prefix64 31/32, packed 45)."""
    jidx, tidx = k21_pair
    if not prefix:
        tidx = SaplingIndex.from_arrays(tidx, device="cpu")
        tidx.prefix64 = tidx.prefix3 = None
    for length in (11, 21, 31, 32, 45):
        codes = _boundary_queries(tidx, length, 600, seed=length)
        want = np.asarray(jidx.query_positions(codes))
        np.testing.assert_array_equal(tidx.query_positions(codes), want,
                                      err_msg=f"L={length}")


def test_adaptive_bounds_parity(k21_pair):
    """adaptive_bounds=True against JAX's adaptive_bounds=True: the same
    (non-reference) search order, so the same duplicate-run member."""
    jidx, tidx = k21_pair
    assert tidx.table.bounds is not None
    for length in (11, 21, 33, 45):
        codes = _queries(jidx.codes, 500, length, seed=61 + length)
        want = np.asarray(jidx.query_positions(
            codes, JaxQueryConfig(adaptive_bounds=True)))
        got = tidx.query_positions(codes, QueryConfig(adaptive_bounds=True))
        np.testing.assert_array_equal(got, want, err_msg=f"L={length}")
    with pytest.raises(ValueError):
        plquery_batch(*_args(tidx, codes), adaptive_bounds=True,
                      **_kw(tidx, length))


def _args(idx, codes):
    """Positional plquery_batch arguments without bounds."""
    dev = idx.device_arrays()
    x, q3, q_words = idx.query_inputs(codes)
    return (dev["packed"], dev["rev"], dev["xlist"], dev["ylist"], q_words,
            x, dev["prefix64"], dev["prefix3"], q3)


def _kw(idx, length, **over):
    t = idx.table
    kw = dict(n=idx.n, length=length, k=idx.k, buckets=idx.buckets,
              most_over=t.most_over, most_under=t.most_under,
              max_over=t.max_over, max_under=t.max_under)
    kw.update(over)
    return kw


def test_pred64_parity(k21_pair):
    """A foreign prediction (the PWL's, moved by seeded noise) with windows
    widened to cover it, through both packages' pred64 seam."""
    jidx, tidx = k21_pair
    jdev = jidx.device_arrays()
    rng = np.random.default_rng(12)
    for length in (16, 21, 33, 45):
        codes = _queries(jidx.codes, 400, length, seed=5 + length)
        x = packops.batch_kmers_adjusted(codes, jidx.k)
        t = jidx.table
        base = predict_pwl(torch.from_numpy(x), torch.from_numpy(t.xlist),
                           torch.from_numpy(t.ylist), 2 * jidx.k,
                           jidx.buckets, jidx.n).numpy()
        pred = np.clip(base + rng.integers(-40, 41, base.shape), 0,
                       jidx.n - 1)
        kw = _kw(jidx, length, most_over=t.most_over + 40,
                 most_under=t.most_under + 40, max_over=t.max_over + 40,
                 max_under=t.max_under + 40)
        q3 = (packops.pack_queries3(codes) if length <= jidx.k else None)
        want = np.asarray(jax_plquery(
            jdev["packed"], jdev["rev"], jdev["xlist"], jdev["ylist"],
            packops.pack_queries(codes), x, jdev["prefix"], jdev["prefix3"],
            q3, pred64=pred, **kw))
        got = plquery_batch(*_args(tidx, codes),
                            pred64=torch.from_numpy(pred), **kw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"L={length}")


def test_max_stride_steps_parity(k21_pair):
    """The phase C cap: one stride step, against JAX's same cap."""
    jidx, tidx = k21_pair
    for length in (33, 60):
        codes = _queries(jidx.codes, 600, length, seed=9 + length)
        want = np.asarray(jidx.query_positions(
            codes, JaxQueryConfig(max_stride_steps=1)))
        got = tidx.query_positions(codes, QueryConfig(max_stride_steps=1))
        np.testing.assert_array_equal(got, want, err_msg=f"L={length}")


def test_uint32_rank_storage_parity():
    """pos_dtype="uint32" (the 2^31 <= n < 2^32 storage): rev ships as an
    int32 view read back as uint32; every path answers as JAX does."""
    seq = benchmark_genome(30_000, seed=91)
    jidx, tidx = _pair(seq, 21, 10, pos_dtype="uint32")
    assert tidx.rev.dtype == np.uint32
    assert tidx.device_arrays()["rev"].dtype == torch.int32
    for length in (16, 21, 31, 45):
        codes = _queries(seq, 400, length, seed=length)
        np.testing.assert_array_equal(
            tidx.query_positions(codes),
            np.asarray(jidx.query_positions(codes)), err_msg=f"L={length}")


def test_count_and_verify_hits_match_jax():
    seq = benchmark_genome(20_000, seed=19)
    jidx, tidx = _pair(seq, 16, 10)
    rng = np.random.default_rng(3)
    ranks = rng.integers(0, len(seq), 3000)
    for a, b in zip(tidx.count_hits(ranks, 32), jidx.count_hits(ranks, 32)):
        np.testing.assert_array_equal(a, b)
    codes = _queries(seq, 500, 16, seed=4)
    pos = rng.integers(-1, len(seq), len(codes))
    pos[:500] = tidx.query_positions(codes[:500])
    np.testing.assert_array_equal(tidx.verify_hits(codes, pos),
                                  jidx.verify_hits(codes, pos))
