"""Parity: the PyTorch port's predict_pwl == sapling_tpu's, exactly.

The same numpy inputs (made from a seed) go through
`sapling_tpu.ops.predict.predict_pwl` (jnp and xp=np) and
`sapling_tpu_torch.ops.predict.predict_pwl` (torch and xp=np). Every
quantity is an integer, so the tolerance is exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sapling_tpu.config import IndexConfig
from sapling_tpu.index.sapling import SaplingIndex
from sapling_tpu.ops.predict import predict_pwl as jax_predict
from sapling_tpu.sim.genomes import benchmark_genome
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.ops.predict import predict_pwl


def _inputs(k, buckets, n_genome, seed):
    """PWL table of a small benchmark genome, plus x values: every
    in-genome k-mer, random out-of-genome values, and the range ends.
    With 2^buckets well above the number of distinct k-mers most buckets
    are empty, i.e. degenerate (xlo == xhi)."""
    seq = benchmark_genome(n_genome, seed=seed)
    idx = SaplingIndex.build(seq, IndexConfig(k=k, buckets=buckets),
                             keep_aligner_arrays=False)
    rng = np.random.default_rng(seed)
    kmers = packops.kmers_scan(idx.codes, k)
    x = np.concatenate([
        kmers,
        rng.integers(0, 1 << (2 * k), 5000, dtype=np.int64),
        np.array([0, (1 << (2 * k)) - 1], np.int64)])
    t = idx.table
    return x, t.xlist, t.ylist, idx.n


@pytest.mark.parametrize("k,buckets", [(16, 10), (16, 16), (21, 12),
                                       (21, 20)])
def test_predict_matches_jax(k, buckets):
    x, xl, yl, n = _inputs(k, buckets, 6000, seed=k * 100 + buckets)
    xl_d = np.diff(xl)
    assert (xl_d == 0).any(), "no degenerate bucket in the table"
    want = np.asarray(jax_predict(jnp.asarray(x), jnp.asarray(xl),
                                  jnp.asarray(yl), 2 * k, buckets, n))
    want_np = jax_predict(x, xl, yl, 2 * k, buckets, n, xp=np)
    got = predict_pwl(torch.from_numpy(x), torch.from_numpy(xl),
                      torch.from_numpy(yl), 2 * k, buckets, n)
    got_np = predict_pwl(x, xl, yl, 2 * k, buckets, n, xp=np)
    np.testing.assert_array_equal(want_np, want)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_np, want)


def test_predict_large_products_match_jax():
    """Genome-scale ranks (n ~ 3.1e9) and wide buckets drive M*N past
    2^63, through the base-2^16 split of the exact division."""
    k, buckets, n = 21, 8, 3_100_000_000
    rng = np.random.default_rng(5)
    nb = 1 << buckets
    xl = np.sort(rng.integers(0, 1 << (2 * k), nb + 1, dtype=np.int64))
    xl[0] = 0
    xl[::7] = xl[1::7][: len(xl[::7])]        # some degenerate buckets
    xl = np.maximum.accumulate(xl)
    yl = np.sort(rng.integers(0, n, nb + 1, dtype=np.int64))
    x = rng.integers(0, 1 << (2 * k), 20000, dtype=np.int64)
    want = jax_predict(x, xl, yl, 2 * k, buckets, n, xp=np)
    got = predict_pwl(torch.from_numpy(x), torch.from_numpy(xl),
                      torch.from_numpy(yl), 2 * k, buckets, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 1000
