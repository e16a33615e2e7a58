"""The port's NN CLI twins of tools/nn_pipeline.py and
tools/bench_nn_query.py on the CPU, and the NN entry points' default device.

nn_pipeline prints the JAX tool's metric lines and writes a model.npz
with the JAX tool's member names, shapes and dtypes; bench_nn_query
self-checks both engines in full."""

import inspect
import os
import re
import sys

import numpy as np
import pytest
import torch

from sapling_tpu_torch.config import IndexConfig
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.io.fasta import write_fasta
from sapling_tpu_torch.models import residual, serve
from sapling_tpu_torch.sim.genomes import benchmark_genome, uniform_genome
from sapling_tpu_torch.tools import bench_nn_query, nn_pipeline

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import nn_pipeline as jax_nn_pipeline  # noqa: E402

_SELF_CHECK = re.compile(r"\[(PWL|NN)\] [\d,]+ q/s .*self-check (\d+)/(\d+)")


def test_nn_pipeline(tmp_path, capsys):
    fa = str(tmp_path / "toy.fa")
    write_fasta(fa, [("toy", bytes(uniform_genome(20_000, seed=2)))])
    args = [fa, "k=11", "chunks=4", "layer_size=4", "epochs=60"]
    assert nn_pipeline.main(["nn", *args, f"out={tmp_path / 'port'}",
                             "device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "sampled 19990 (rank, kmer) pairs" in out
    assert "dataset: 4 chunks x 4998 points" in out
    m = re.search(r"trained (\d+) epochs, final mean loss [\d.]+ "
                  r"\((\d+)/4 chunks early-stopped\)", out)
    assert m and 1 <= int(m[1]) <= 60, out
    for key in ("mean", "p50", "p75", "p90", "p95", "p99", "p100"):
        assert re.search(rf"^  {key}: [\d,.]+ rows$", out, re.M), key
    assert np.load(tmp_path / "port" / "loss.npy").shape == (int(m[1]), 4)

    assert jax_nn_pipeline.main(["nn", *args, "epochs=2",
                                 f"out={tmp_path / 'jax'}"]) == 0
    with np.load(tmp_path / "port" / "model.npz") as a, \
            np.load(tmp_path / "jax" / "model.npz") as b:
        assert {m: (a[m].shape, a[m].dtype) for m in a.files} == {
            m: (b[m].shape, b[m].dtype) for m in b.files}


def test_bench_nn_query(tmp_path, capsys):
    """The tool loads a saved artifact, trains, audits and times both
    engines, self-checking each."""
    path = str(tmp_path / "q.stpu.npz")
    SaplingIndex.build(benchmark_genome(100_000),
                       IndexConfig(k=15, buckets=10), device="cpu").save(path)
    argv = ["bnq", path, "nq=3000", "chunks=8", "size=8", "epochs=40",
            "iters=1", "device=cpu"]
    assert bench_nn_query.main(argv) == 0
    out = capsys.readouterr().out
    assert "loaded n=100,000 2^10" in out
    found = _SELF_CHECK.findall(out)
    assert [f[0] for f in found] == ["PWL", "NN"], out
    assert all(a == b == "3000" for _, a, b in found), out
    assert re.search(r"NN  windows: most=\(\d+,\d+\) max=\(\d+,\d+\)", out)
    assert "NN/PWL = " in out


def test_entry_points_default_to_the_card():
    """Trainer.create and the tools default to "cuda"; train_serving and
    NNQueryEngine run on the index's device, so with no GPU a default
    index's training raises instead of running on the CPU."""
    assert inspect.signature(
        residual.Trainer.create).parameters["device"].default == "cuda"
    assert inspect.signature(
        residual.init_params).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the defaults run there")
    no_gpu = (AssertionError, RuntimeError)
    with pytest.raises(no_gpu):
        residual.Trainer.create(0, 2, 4)
    idx = SaplingIndex.build(uniform_genome(5_000, seed=1),
                             IndexConfig(k=11, buckets=6))
    with pytest.raises(no_gpu):
        serve.train_serving(idx, num_chunks=2, layer_size=4, epochs=1)
    cpu_srv = serve.train_serving(idx.to("cpu"), num_chunks=2, layer_size=4,
                                  epochs=1)
    with pytest.raises(no_gpu):
        serve.NNQueryEngine(idx, cpu_srv)
