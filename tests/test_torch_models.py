"""The port's stacked residual-MLP family (sapling_tpu_torch.models.residual)
against sapling_tpu.models.residual on the CPU.

From the same initial parameters (JAX's, carried across with
params_from_numpy) the port's trainer follows the JAX trainer to rounding:
the same per-chunk stop epochs, loss histories within rtol 1e-12 and final
parameters within 1e-12, full batch and with minibatches."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sapling_tpu.config import IndexConfig
from sapling_tpu.index.sapling import SaplingIndex
from sapling_tpu.models import residual as jres
from sapling_tpu.ops.pack import kmers_scan
from sapling_tpu.sim.genomes import uniform_genome
from sapling_tpu_torch.io.fasta import write_fasta
from sapling_tpu_torch.models import residual

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import nn_pipeline as jax_nn_pipeline  # noqa: E402


def _corpus(n=8000, k=11):
    """test_models.py's _dataset() corpus: (kmers, ranks)."""
    idx = SaplingIndex.build(uniform_genome(n, seed=5),
                             IndexConfig(k=k, buckets=6))
    kmers = kmers_scan(idx.codes, k)
    return kmers, np.asarray(idx.inv[: kmers.shape[0]])


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


def _jax_init(seed, chunks, size):
    """JAX's initial parameters as numpy arrays."""
    t = jres.Trainer.create(jax.random.PRNGKey(seed), chunks, size)
    return jax.tree.map(np.asarray, t.params)


def _jax_trainer(init):
    params = jax.tree.map(jnp.asarray, init)
    opt = jres.Trainer.create(jax.random.PRNGKey(0), 1, 1).opt
    return jres.Trainer(params=params, opt=opt, opt_state=opt.init(params))


def _trainer(init):
    """The port's trainer from the same initial parameters, on the CPU."""
    return residual.Trainer.from_params(residual.params_from_numpy(init,
                                                                   "cpu"))


def _assert_params_close(ours, theirs, atol):
    ours = residual.params_to_numpy(ours)
    theirs = jax.tree.map(np.asarray, theirs)
    for a, b in zip(ours, theirs):
        for name in ("w", "b"):
            np.testing.assert_allclose(a[name], b[name], rtol=0, atol=atol)


@pytest.mark.parametrize("stride", [1, 3])
def test_prepare_dataset_equal(corpus, stride):
    kmers, ranks = corpus
    ours = residual.prepare_dataset(kmers, ranks, 5, sample_stride=stride)
    theirs = jres.prepare_dataset(kmers, ranks, 5, sample_stride=stride)
    for f in ("x", "res", "valid"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("res_min", "res_ptp", "line_m", "line_c", "x_max"):
        assert getattr(ours, f) == getattr(theirs, f), f


def test_forward_and_loss_match(corpus):
    kmers, ranks = corpus
    ds = jres.prepare_dataset(kmers, ranks, 4)
    init = _jax_init(2, 4, 8)
    params = residual.params_from_numpy(init, "cpu")
    assert all(t.dtype == torch.float64 for layer in params
               for t in layer.values())
    x, y = torch.from_numpy(ds.x), torch.from_numpy(ds.res)
    v = torch.from_numpy(ds.valid.astype(np.float32))
    np.testing.assert_allclose(
        residual.forward(params, x).numpy(),
        np.asarray(jres.forward(init, jnp.asarray(ds.x))), rtol=0, atol=1e-15)
    jv = jnp.asarray(ds.valid.astype(np.float32))
    np.testing.assert_allclose(
        residual.mse_loss_per_chunk(params, x, y, v).numpy(),
        np.asarray(jres.mse_loss_per_chunk(init, jnp.asarray(ds.x),
                                           jnp.asarray(ds.res), jv)),
        rtol=0, atol=1e-15)
    model = residual.StackedMLP(params)
    assert torch.equal(model(x), residual.forward(params, x))


def test_train_step_matches(corpus):
    kmers, ranks = corpus
    ds = jres.prepare_dataset(kmers, ranks, 4)
    init = _jax_init(0, 4, 8)
    jt = _jax_trainer(init)
    v = ds.valid.astype(np.float32)
    jp, _, jloss = jt.train_step()(jt.params, jt.opt_state, jnp.asarray(ds.x),
                                   jnp.asarray(ds.res), jnp.asarray(v))
    ours = _trainer(init)
    loss = ours.train_step(ds.x, ds.res, v)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-14)
    assert ours.opt_state.count == 1
    _assert_params_close(ours.params, jp, atol=1e-15)


@pytest.mark.parametrize("batch,epochs", [(None, 200), (16, 5)])
def test_fit_matches_jax(corpus, batch, epochs):
    kmers, ranks = corpus
    ds = jres.prepare_dataset(kmers, ranks, 4)
    init = _jax_init(0, 4, 8)
    jt = _jax_trainer(init)
    jh = jt.fit(ds, epochs=epochs, convergence_window=60, batch=batch)
    ours = _trainer(init)
    h = ours.fit(ds, epochs=epochs, convergence_window=60, batch=batch)
    np.testing.assert_array_equal(ours.stop_epochs, jt.stop_epochs)
    if batch is None:
        assert (jt.stop_epochs >= 0).any()     # the stop rule was exercised
    assert h.shape == jh.shape
    np.testing.assert_allclose(h, jh, rtol=1e-12, atol=0)
    _assert_params_close(ours.params, jt.params, atol=1e-12)
    np.testing.assert_allclose(ours.predict_rows(ds), jt.predict_rows(ds),
                               rtol=1e-12)


def test_predict_rows_and_error_percentiles(corpus):
    kmers, ranks = corpus
    ds = jres.prepare_dataset(kmers, ranks, 4)
    init = _jax_init(1, 4, 8)
    ours = _trainer(init)
    jt = _jax_trainer(init)
    rows = ours.predict_rows(ds)
    np.testing.assert_allclose(rows, jt.predict_rows(ds), rtol=0, atol=1e-9)
    true_rows = ranks[np.argsort(kmers, kind="stable")].astype(np.float64)
    assert residual.error_percentiles(rows, true_rows) == \
        jres.error_percentiles(rows, true_rows)


def test_init_params_bounds_and_seed():
    a = residual.Trainer.create(7, 5, 6, hidden_layers=2, device="cpu")
    b = residual.Trainer.create(torch.Generator().manual_seed(7), 5, 6,
                                hidden_layers=2, device="cpu")
    shapes = [(t["w"].shape, t["b"].shape) for t in a.params]
    assert shapes == [((5, 1, 6), (5, 6)), ((5, 6, 6), (5, 6)),
                      ((5, 6, 1), (5, 1))]
    for la, lb, din in zip(a.params, b.params, (1, 6, 6)):
        for name in ("w", "b"):
            assert la[name].dtype == torch.float64
            assert torch.equal(la[name], lb[name])
            assert la[name].abs().max() <= 1 / np.sqrt(din)


def test_training_reduces_loss_and_beats_line():
    kmers, ranks = _corpus()
    ds = residual.prepare_dataset(kmers, ranks, 4)
    trainer = residual.Trainer.create(0, num_chunks=ds.x.shape[0],
                                      layer_size=8, device="cpu")
    losses = trainer.fit(ds, epochs=200, convergence_window=60)
    assert losses.ndim == 2 and losses.shape[1] == ds.x.shape[0]
    assert losses[-1].mean() < losses[0].mean() * 0.9, \
        "training did not reduce loss"
    rows = trainer.predict_rows(ds)
    order = np.argsort(kmers, kind="stable")
    true_rows = ranks[order].astype(np.float64)
    metrics = residual.error_percentiles(rows, true_rows)
    line_rows = ds.x[..., 0][ds.valid] * ds.line_m + ds.line_c
    line_err = np.abs(line_rows - true_rows).mean()
    assert metrics["mean"] < line_err


def test_per_chunk_convergence_matches_scalar_reruns():
    """Each chunk's early-stop epoch (and loss history) in the one stacked
    trainer equals a standalone single-chunk training run — the
    reference's execution model (one process per chunk, fit.py:259-277)."""
    kmers, ranks = _corpus(n=4000)
    ds = residual.prepare_dataset(kmers, ranks, 3)
    trainer = residual.Trainer.create(6, num_chunks=ds.x.shape[0],
                                      layer_size=6, device="cpu")
    init = residual.params_to_numpy(trainer.params)
    losses = trainer.fit(ds, epochs=150, convergence_window=25)
    stops = trainer.stop_epochs.copy()
    assert (stops >= 0).any()

    for c in range(ds.x.shape[0]):
        sub = residual.ResidualDataset(
            x=ds.x[c : c + 1], res=ds.res[c : c + 1],
            valid=ds.valid[c : c + 1], res_min=ds.res_min,
            res_ptp=ds.res_ptp, line_m=ds.line_m, line_c=ds.line_c,
            x_max=ds.x_max)
        sp = [{k: v[c : c + 1] for k, v in layer.items()} for layer in init]
        solo = _trainer(sp)
        solo_losses = solo.fit(sub, epochs=150, convergence_window=25)
        assert solo.stop_epochs[0] == stops[c], (
            f"chunk {c}: stacked stop {stops[c]} vs solo "
            f"{solo.stop_epochs[0]}")
        np.testing.assert_allclose(solo_losses[:, 0],
                                   losses[: len(solo_losses), c],
                                   rtol=1e-12)


def test_jax_model_npz_loads(tmp_path):
    """The model.npz that the JAX nn_pipeline writes loads through
    params_from_numpy and gives JAX's forward output."""
    fa = str(tmp_path / "toy.fa")
    write_fasta(fa, [("toy", bytes(uniform_genome(20_000, seed=2)))])
    args = [fa, "k=11", "chunks=4", "layer_size=4", "epochs=3"]
    assert jax_nn_pipeline.main(["nn", *args, f"out={tmp_path}"]) == 0
    with np.load(tmp_path / "model.npz") as z:
        jax_members = {m: z[m] for m in z.files}
    layers = [{"w": jax_members[f"p{i}_w"], "b": jax_members[f"p{i}_b"]}
              for i in range(2)]
    x = np.random.default_rng(0).random((4, 50, 1)).astype(np.float32)
    np.testing.assert_allclose(
        residual.forward(residual.params_from_numpy(layers, "cpu"),
                         torch.from_numpy(x)).numpy(),
        np.asarray(jres.forward(layers, jnp.asarray(x))), rtol=0, atol=1e-15)

