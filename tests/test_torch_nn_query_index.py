"""The NN predictor trained and audited from a query-time index
(sapling_tpu_torch.models.serve: kmer_stream, train_serving,
audit_serving), saved and loaded (save_serving, load_serving), on the CPU.

A query-time index is loaded without inv, codes and the lcp >= k runs, as
a server loads it; the model must come out of it as it comes out of the
whole index's host arrays: the (k-mer, rank) stream and its runs equal to
ops.pack.kmers_scan, inv and index.suffix_array.fwd_runs_from_rank_kmers,
and the whole training the host pipeline's (the numpy dataset, the
trainer from the same seed, the audit of every k-mer over the host runs):
the same dataset, bit-identical parameters and the same four windows, on
seeded random weights (no epoch) and on a briefly trained model.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sapling_tpu_torch.config import IndexConfig
from sapling_tpu_torch.index.pwl import ErrorAudit, error_stats
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.index.suffix_array import fwd_runs_from_rank_kmers
from sapling_tpu_torch.models.residual import Trainer, prepare_dataset
from sapling_tpu_torch.models.serve import (NNQueryEngine, NNServing,
                                            kmer_stream, load_serving,
                                            save_serving, train_serving)
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.sim.genomes import benchmark_genome, repeat_genome

WINDOWS = ("most_over", "most_under", "max_over", "max_under")
# the members a lookup never reads (portbench.index_cache.QUERY_SKIP)
QUERY_SKIP = ("inv", "codes", "lcpk_fwd", "lcpk_bwd")


def _genome():
    """Repeats (runs of equal k-mers) beside a benchmark-like genome."""
    return np.concatenate([repeat_genome(2000, period=37, seed=5),
                           benchmark_genome(18_000, seed=6)])


@pytest.fixture(scope="module", params=[("int32", 13), ("int64", 21)],
                ids=["int32-k13", "int64-k21"])
def indexes(request, tmp_path_factory):
    """(the whole index, the same artifact loaded as a server loads it)."""
    pos_dtype, k = request.param
    idx = SaplingIndex.build(
        _genome(), IndexConfig(k=k, buckets=10, pos_dtype=pos_dtype),
        device="cpu")
    path = str(tmp_path_factory.mktemp("nn_query_index") / "i.stpu.npz")
    idx.save(path)
    query = SaplingIndex.load(path, skip=QUERY_SKIP, mmap=True,
                              device="cpu")
    assert query.codes is None and not len(query.inv)
    return idx, query


def host_pipeline(idx, chunks, units, epochs, seed):
    """train_serving as the host arrays give it: kmers_scan of the codes,
    inv, the numpy dataset, the trainer, and the audit over
    fwd_runs_from_rank_kmers with error_stats: (dataset, serving model)."""
    kmers = packops.kmers_scan(idx.codes, idx.k)
    ranks = np.asarray(idx.inv[:kmers.shape[0]], dtype=np.int64)
    ds = prepare_dataset(kmers, ranks, chunks)
    trainer = Trainer.create(seed, ds.x.shape[0], units, device="cpu")
    trainer.fit(ds, epochs=epochs)
    srv = NNServing(
        params=[{k: v.detach() for k, v in layer.items()}
                for layer in trainer.params],
        xb=torch.from_numpy(np.ascontiguousarray(ds.x[:, 0, 0])),
        x_max=ds.x_max, res_min=ds.res_min, res_ptp=ds.res_ptp,
        line_m=ds.line_m, line_c=ds.line_c, n=idx.n, k=idx.k)
    fwd = fwd_runs_from_rank_kmers(kmers, idx.inv, idx.n)
    pred = srv.predict_ranks(torch.from_numpy(kmers)).numpy()
    runs = np.where(ranks < fwd.shape[0],
                    fwd[np.minimum(ranks, fwd.shape[0] - 1)], 0)
    shifted = np.where(ranks < pred, np.minimum(pred, ranks + runs), ranks)
    errors = shifted - pred
    mo, mu, _, so, su = error_stats(ErrorAudit(
        errors=errors, perfect_predictions=int((errors == 0).sum())))
    srv.max_over, srv.max_under, srv.most_over, srv.most_under = \
        mo, mu, so, su
    return ds, srv


def test_kmer_stream_from_rev_and_the_packed_genome(indexes):
    """The stream a query-time index gives (rev and the packed genome
    alone) is the host arrays' stream, and so is the whole index's."""
    idx, query = indexes
    kmers = packops.kmers_scan(idx.codes, idx.k)
    want = (kmers, np.asarray(idx.inv[:kmers.shape[0]], np.int64),
            fwd_runs_from_rank_kmers(kmers, idx.inv, idx.n))
    assert want[2].max() > 1, "the genome should hold repeated k-mers"
    for got in (kmer_stream(query), kmer_stream(idx)):
        assert [t.dtype for t in got] == [torch.int64, torch.int64,
                                          torch.int32]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("epochs", [0, 12], ids=["random", "trained"])
def test_training_from_a_query_index_equals_the_host_pipeline(indexes,
                                                              epochs):
    """train_serving on the query-time index == the host pipeline on the
    whole index: the same dataset, the same parameters bit for bit (from
    the same seed; 0 epochs keeps the seeded random weights), the same
    boundaries, constants and four windows."""
    idx, query = indexes
    ds, want = host_pipeline(idx, 8, 6, epochs, seed=3)
    got_ds = prepare_dataset(*kmer_stream(query)[:2], 8)
    for name in ("x", "res", "valid"):
        np.testing.assert_array_equal(getattr(got_ds, name).numpy(),
                                      getattr(ds, name))
    for name in ("x_max", "res_min", "res_ptp", "line_m", "line_c"):
        assert getattr(got_ds, name) == getattr(ds, name), name
    got = train_serving(query, num_chunks=8, layer_size=6, epochs=epochs,
                        seed=3)
    assert got.epochs_run == epochs
    for lg, lw in zip(got.params, want.params):
        for name in ("w", "b"):
            assert lg[name].equal(lw[name]), name
    assert got.xb.equal(want.xb)
    for name in ("x_max", "res_min", "res_ptp", "line_m", "line_c", "n",
                 "k") + WINDOWS:
        assert getattr(got, name) == getattr(want, name), name


def test_saved_model_loads_bit_for_bit(indexes, tmp_path):
    """A model saved and loaded gives the same parameters, boundaries,
    constants, windows and training counts, the same ranks and the same
    positions."""
    _, query = indexes
    srv = train_serving(query, num_chunks=8, layer_size=6, epochs=6, seed=4)
    path = str(tmp_path / "model.npz")
    save_serving(srv, path)
    back = load_serving(path, "cpu")
    for lg, lw in zip(back.params, srv.params):
        assert all(lg[n].equal(lw[n]) and lg[n].dtype == torch.float64
                   for n in ("w", "b"))
    assert back.xb.equal(srv.xb) and back.xb.dtype == torch.float32
    fields = [f.name for f in dataclasses.fields(NNServing)
              if f.name not in ("params", "xb", "_plan")]
    assert [getattr(back, f) for f in fields] == [getattr(srv, f)
                                                  for f in fields]
    assert isinstance(back.n, int) and isinstance(back.x_max, float)
    kmers = kmer_stream(query)[0]
    assert back.predict_ranks(kmers).equal(srv.predict_ranks(kmers))
    rng = np.random.default_rng(9)
    starts = rng.integers(0, query.n - query.k, 500)
    g = packops.encode_bases(_genome())
    codes = g[starts[:, None] + np.arange(query.k)]
    assert np.array_equal(NNQueryEngine(query, back).query_positions(codes),
                          NNQueryEngine(query, srv).query_positions(codes))


def test_a_plan_of_the_model_is_made_once_and_anew_for_new_arrays(
        indexes, monkeypatch):
    """NNServing.plan makes one serving plan for the model's arrays and
    keeps it; another tensor in the model's place makes it anew (the
    plan's library is not touched on the CPU)."""
    from sapling_tpu_torch.ops import nn_predict_cuda

    _, query = indexes
    srv = train_serving(query, num_chunks=4, layer_size=3, epochs=0, seed=1)
    monkeypatch.setattr(nn_predict_cuda, "_lib", lambda: object())
    made = nn_predict_cuda.PLANS["made"]
    p = srv.plan()
    assert srv.plan() is p and nn_predict_cuda.PLANS["made"] == made + 1
    srv.params[1]["b"] = srv.params[1]["b"].clone()
    assert srv.plan() is not p and nn_predict_cuda.PLANS["made"] == made + 2
    srv.params[1]["b"] = srv.params[1]["b"][:, :0]
    with pytest.raises(ValueError, match="b2 must be"):
        srv.plan()
