"""The port's NN-predictor query engine (sapling_tpu_torch.models.serve)
against sapling_tpu.models.serve on the CPU.

With JAX's trained model carried across (serving_from_numpy) the port
predicts the same rank for every genome k-mer, audits the same four
windows and answers every query lane with the same position. The twins of
tests/test_serve.py's contract tests run on the port's own training."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sapling_tpu.config import IndexConfig as JaxIndexConfig
from sapling_tpu.index.sapling import SaplingIndex as JaxIndex
from sapling_tpu.models import serve as jserve
from sapling_tpu_torch.config import IndexConfig
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.models.serve import (NNQueryEngine, audit_serving,
                                            serving_from_numpy, train_serving)
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.sim.genomes import uniform_genome

K = 13
WINDOWS = ("most_over", "most_under", "max_over", "max_under")


@pytest.fixture(scope="module")
def jax_setup():
    """test_serve.py's fixture: the JAX index and its trained model, the
    port's index on the same arrays and the JAX model carried across."""
    g = uniform_genome(200_000, seed=3)
    jidx = JaxIndex.build(g, JaxIndexConfig(k=K, buckets=12))
    jsrv = jserve.train_serving(jidx, num_chunks=8, layer_size=8,
                                epochs=150, seed=1)
    idx = SaplingIndex.from_arrays(jidx, device="cpu")
    return g, jidx, jsrv, idx, serving_from_numpy(jsrv, "cpu")


@pytest.fixture(scope="module")
def nn_setup(jax_setup):
    """The port's own training on the same index."""
    g, _, _, idx, _ = jax_setup
    srv = train_serving(idx, num_chunks=8, layer_size=8, epochs=150, seed=1)
    return g, idx, srv, NNQueryEngine(idx, srv)


def _queries(g, n):
    """3,000 present and 2,000 random 13-mers."""
    rng = np.random.default_rng(0)
    pos = rng.integers(0, n - K + 1, 3000)
    present = packops.encode_bases(g[pos[:, None] + np.arange(K)])
    rand = np.random.default_rng(7).integers(0, 4, (2000, K)).astype(np.uint8)
    return np.concatenate([present, rand])


def test_predict_ranks_equal_jax(jax_setup):
    _, jidx, jsrv, idx, srv = jax_setup
    km = packops.kmers_scan(idx.codes, K)
    want = np.asarray(jax.jit(jsrv.predict_ranks)(jnp.asarray(km)))
    got = srv.predict_ranks(torch.from_numpy(km))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_audit_windows_equal_jax(jax_setup):
    _, jidx, jsrv, idx, srv = jax_setup
    fresh = dataclasses.replace(srv)
    audit = audit_serving(fresh, idx)
    jaudit = jserve.audit_serving(dataclasses.replace(jsrv), jidx)
    np.testing.assert_array_equal(audit.errors, jaudit.errors)
    assert [getattr(fresh, w) for w in WINDOWS] == \
        [getattr(jsrv, w) for w in WINDOWS]


@pytest.mark.parametrize("prefix", [True, False])
def test_engine_positions_equal_jax(jax_setup, prefix):
    """Every lane, present and random, as JAX's engine answers it; without
    prefix arrays the port probes the packed genome and still agrees."""
    g, jidx, jsrv, idx, srv = jax_setup
    codes = _queries(g, idx.n)
    want = jserve.NNQueryEngine(jidx, jsrv).query_positions(codes)
    if not prefix:
        idx = dataclasses.replace(idx, prefix64=None, prefix3=None,
                                  _device={})
    got = NNQueryEngine(idx, srv).query_positions(codes)
    np.testing.assert_array_equal(got, want)


def test_serving_to_device(jax_setup):
    srv = jax_setup[4]
    assert srv.to("cpu") is srv and srv.device == torch.device("cpu")


def test_nn_engine_present_queries_found_and_verified(nn_setup):
    g, idx, srv, eng = nn_setup
    rng = np.random.default_rng(0)
    pos = rng.integers(0, idx.n - K + 1, 3000)
    codes = packops.encode_bases(g[pos[:, None] + np.arange(K)])
    out_nn = eng.query_positions(codes)
    out_pwl = idx.query_positions(codes)
    assert (out_nn >= 0).all()
    assert (out_pwl >= 0).all()
    assert idx.verify_hits(codes, out_nn).all()
    # unique k-mers leave no duplicate-choice freedom: exact parity
    km = packops.kmers_scan(idx.codes, K)
    vals, counts = np.unique(km, return_counts=True)
    kq = idx.kmerize_batch(codes)
    uniq = counts[np.searchsorted(vals, kq)] == 1
    assert uniq.sum() > 2000
    assert np.array_equal(out_nn[uniq], out_pwl[uniq])


def test_nn_engine_absent_queries_never_false_verify(nn_setup):
    g, idx, srv, eng = nn_setup
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, (2000, K)).astype(np.uint8)
    out_nn = eng.query_positions(codes)
    ver = idx.verify_hits(codes, out_nn)
    km = packops.kmers_scan(idx.codes, K)
    present = np.isin(idx.kmerize_batch(codes), km)
    assert (ver <= present).all()  # verified => present
    assert (out_nn[present] >= 0).all()
    assert ver[present].all()


def test_nn_audit_windows_cover_errors(nn_setup):
    g, idx, srv, eng = nn_setup
    audit = audit_serving(srv, idx)
    err = audit.errors
    assert srv.max_over >= int(err.max(initial=0))
    assert srv.max_under >= int(-err.min(initial=0))
    assert srv.most_over >= 1 and srv.most_under >= 1


def test_nn_engine_rejects_other_lengths(nn_setup):
    _g, _idx, _srv, eng = nn_setup
    with pytest.raises(NotImplementedError):
        eng.query_positions(np.zeros((4, K + 2), np.uint8))


def test_nn_engine_rejects_another_index(nn_setup):
    _g, _idx, srv, _eng = nn_setup
    other = SaplingIndex.build(uniform_genome(30_000, seed=4),
                               IndexConfig(k=K, buckets=8), device="cpu")
    with pytest.raises(ValueError, match="different index"):
        NNQueryEngine(other, srv)


def test_untrained_model_still_correct():
    """Bounds, not model quality, carry correctness: a nearly-untrained
    model (2 epochs) must still find every present query — its audited
    max windows are just wider."""
    g = uniform_genome(60_000, seed=9)
    idx = SaplingIndex.build(g, IndexConfig(k=K, buckets=10), device="cpu")
    srv = train_serving(idx, num_chunks=4, layer_size=4, epochs=2, seed=5)
    eng = NNQueryEngine(idx, srv)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, idx.n - K + 1, 500)
    codes = packops.encode_bases(g[pos[:, None] + np.arange(K)])
    out = eng.query_positions(codes)
    assert (out >= 0).all()
    assert idx.verify_hits(codes, out).all()
