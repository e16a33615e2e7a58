"""The CUDA kernel of the NN rank prediction on the card (skipped without a
GPU).

The kernel (sapling_tpu_torch/csrc/nn_predict.cu) has no CPU mode, so these
tests need a CUDA device; here they skip. They import neither jax nor
sapling_tpu, so they run on a machine without JAX, from the repo root:

    python -m pytest --noconftest tests/test_torch_nn_predict_cuda.py -q

The reference is the plain PyTorch nn_predict on the same CUDA tensors and
on the CPU: every rank must be equal. NNQueryEngine's positions on the card
must equal the CPU path's with the same model, from one nn_predict and one
plquery launch a call, each from a plan without stats (the plan's
positions plquery_cuda's pred64 call's); training on the card is the same
bit for bit twice, and from the index loaded as a server loads it.
tests/test_torch_nn_predict_cu_on_cpu.py holds the same source on the
CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sapling_tpu_torch.config import IndexConfig
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.index import sapling
from sapling_tpu_torch.models import serve
from sapling_tpu_torch.models.serve import NNQueryEngine, train_serving
from sapling_tpu_torch.ops import nn_predict_cuda, query_cuda
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.sim.genomes import uniform_genome

from .nn_cases import GROUPING, grouping_case, random_model


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _model(c, s, seed, x_max, scale, n, device):
    """nn_cases.random_model's parameters and boundaries on `device`."""
    args, kw = random_model(c, s, seed, x_max, scale, n)
    return tuple(a.to(device) for a in args), kw


@pytest.mark.cuda
@pytest.mark.parametrize("c,s", [(64, 16), (8, 16), (3, 5), (300, 41)])
def test_nn_kernel_matches_plain(dev, c, s):
    """Random models (parameters staged in shared memory, and at C = 300,
    s = 41 past the staging limit, read in place) on 1M random x and the
    edges (0, x_max, chunk boundaries), at rank scale and where a double
    steps by 0.5 (rows past 2^51): every rank equal to the plain version's
    on the card and on the CPU, one launch a call."""
    x_max = 4 ** 21 - 1
    rng = np.random.default_rng(c + s)
    for scale, n in ((4.6e6, 4_600_000), (2.0 ** 51, 2 ** 53)):
        args, kw = _model(c, s, c * 100 + s, x_max, scale, n, dev)
        at = np.round(args[0].cpu().numpy().astype(np.float64) * x_max)
        x = np.concatenate([[0, 1, x_max - 1, x_max], at - 1, at, at + 1,
                            rng.integers(0, x_max + 1, 1_000_000)])
        x = torch.from_numpy(np.clip(x, 0, x_max).astype(np.int64)).to(dev)
        want = nn_predict_cuda.nn_predict(x, *args, **kw)
        before = nn_predict_cuda.LAUNCHES["nn_predict"]
        got = nn_predict_cuda.nn_predict_cuda(x, *args, **kw)
        torch.cuda.synchronize()
        assert nn_predict_cuda.LAUNCHES["nn_predict"] == before + 1
        assert torch.equal(got, want), int((got != want).sum())
        host = nn_predict_cuda.nn_predict(
            x.cpu(), *(a.cpu() for a in args), **kw)
        assert torch.equal(got.cpu(), host), int((got.cpu() != host).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUPING))
def test_nn_kernel_grouping_cases(dev, case):
    """tests/test_torch_nn_predict_cu_on_cpu.py's grouping cases on the
    card (one chunk, every chunk in random and sorted order, B = 1, 31 and
    a tile plus one, C = 1, s = 1, 5, 16 and 33, the global path, binned
    chunks, boundaries in one cell of the search table, x past x_max):
    every rank equal to the plain version's, one launch a call."""
    for scale, n in ((float(4 ** 13), 4 ** 13), (2.0 ** 51, 2 ** 53)):
        args, kw, x = grouping_case(case, scale, n)
        want = nn_predict_cuda.nn_predict(x, *args, **kw)
        args, x = tuple(a.to(dev) for a in args), x.to(dev)
        before = nn_predict_cuda.LAUNCHES["nn_predict"]
        got = nn_predict_cuda.nn_predict_cuda(x, *args, **kw)
        torch.cuda.synchronize()
        assert nn_predict_cuda.LAUNCHES["nn_predict"] == before + 1
        assert torch.equal(got.cpu(), want), int((got.cpu() != want).sum())


@pytest.fixture(scope="module")
def trained():
    """tests/test_torch_serve.py's nn_setup on the card: a 200 kbp genome,
    k=13, 8 chunks of 8 units, 150 epochs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    g = uniform_genome(200_000, seed=3)
    idx = SaplingIndex.build(g, IndexConfig(k=13, buckets=12), device="cpu")
    didx = idx.to("cuda")
    srv = train_serving(didx, num_chunks=8, layer_size=8, epochs=150, seed=1)
    return g, idx, didx, srv


@pytest.mark.cuda
def test_nn_engine_on_the_card_equals_the_cpu_path(dev, trained):
    """Every k-mer's rank on the card == the same model's on the CPU;
    NNQueryEngine on the card: one nn_predict and one plquery launch a call,
    positions equal to the CPU path's."""
    g, idx, didx, srv = trained
    host = srv.to("cpu")
    km = torch.from_numpy(packops.kmers_scan(idx.codes, idx.k))
    assert torch.equal(srv.predict_ranks(km.to(dev)).cpu(),
                       host.predict_ranks(km))
    rng = np.random.default_rng(0)
    pos = rng.integers(0, idx.n - idx.k + 1, 30_000)
    codes = np.concatenate([
        packops.encode_bases(g[pos[:, None] + np.arange(idx.k)]),
        rng.integers(0, 4, (5000, idx.k)).astype(np.uint8)])
    eng = NNQueryEngine(didx, srv)
    inputs = eng.query_inputs(codes)
    assert inputs[1] is not None   # the fast3 probe's q3
    before = (nn_predict_cuda.LAUNCHES["nn_predict"],
              query_cuda.LAUNCHES["plquery"])
    got = eng.query_device(*inputs).cpu().numpy()
    torch.cuda.synchronize()
    assert (nn_predict_cuda.LAUNCHES["nn_predict"],
            query_cuda.LAUNCHES["plquery"]) == (before[0] + 1, before[1] + 1)
    want = NNQueryEngine(idx, host).query_positions(codes)
    np.testing.assert_array_equal(got, want)
    assert idx.verify_hits(codes, got)[:30_000].all()


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(dev, trained):
    _, _, _, srv = trained
    x = torch.zeros(10, dtype=torch.int64, device=dev)
    w1, b1 = srv.params[0]["w"], srv.params[0]["b"]
    w2, b2 = srv.params[1]["w"], srv.params[1]["b"]
    kw = dict(x_max=srv.x_max, line_m=srv.line_m, line_c=srv.line_c,
              res_ptp=srv.res_ptp, res_min=srv.res_min, n=srv.n)
    with pytest.raises(ValueError):                      # dtype
        nn_predict_cuda.nn_predict_cuda(x, srv.xb, w1.float(), b1, w2, b2,
                                        **kw)
    with pytest.raises(ValueError):                      # device
        nn_predict_cuda.nn_predict_cuda(x, srv.xb.cpu(), w1, b1, w2, b2,
                                        **kw)
    with pytest.raises(ValueError):                      # layout
        nn_predict_cuda.nn_predict_cuda(
            x, srv.xb, w1, b1.t().contiguous().t(), w2, b2, **kw)
    deeper = dataclasses.replace(srv, params=srv.params + srv.params[:1])
    with pytest.raises(NotImplementedError):             # hidden_layers 2
        deeper.predict_ranks(x)


def _codes(g, n, k, num, seed):
    """num genome k-mers and num // 6 random ones."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, n - k + 1, num)
    return np.concatenate([
        packops.encode_bases(g[pos[:, None] + np.arange(k)]),
        rng.integers(0, 4, (num // 6, k)).astype(np.uint8)])


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fast3", "packed", "ranks"])
def test_nn_engine_requests_launch_from_plans(dev, trained, monkeypatch,
                                              form):
    """Without stats every NN request on the card launches from plans made
    before it (the model's serving plan, the engine's PlqueryPlan without
    bucket records): its positions equal plquery_cuda's pred64 call on the
    same tensors, on fast3, on rev and the genome, and on rank records;
    after the first request one that reaches plquery_cuda or
    nn_predict_cuda, or checks the model's arrays again, fails."""
    g, idx, _, srv = trained
    host = idx if form == "fast3" else SaplingIndex.from_arrays(idx, "cpu")
    if form != "fast3":
        host.prefix64 = host.prefix3 = None
    monkeypatch.setattr(sapling, "reads_rank_records",
                        lambda rev, packed: form == "ranks")
    didx = host.to(dev)
    eng = NNQueryEngine(didx, srv)
    x, q3, q_words = eng.query_inputs(_codes(g, idx.n, idx.k, 20_000, 5))
    d = didx.device_arrays()
    ranks = didx.query_records()[1]
    assert (ranks is not None) == (form == "ranks")
    pred = nn_predict_cuda.nn_predict_cuda(x, *srv._arrays(), **srv._consts())
    want = query_cuda.plquery_cuda(
        d["packed"], d["rev"], d["xlist"], d["ylist"], q_words, x,
        d["prefix64"], d["prefix3"], q3, n=didx.n, length=didx.k,
        k=didx.k, buckets=didx.buckets, most_over=srv.most_over,
        most_under=srv.most_under, max_over=srv.max_over,
        max_under=srv.max_under, pred64=pred, rank_recs=ranks)
    assert eng.query_device(x, q3, q_words).equal(want)

    def refuse(*args, **kw):
        raise AssertionError("a request left the plans")

    for module, name in ((serve, "plquery_cuda"), (serve, "nn_predict_cuda"),
                         (nn_predict_cuda, "_check_model"),
                         (query_cuda, "_check_index")):
        monkeypatch.setattr(module, name, refuse)
    served = (query_cuda.PLANS["served"], nn_predict_cuda.PLANS["served"])
    made = (query_cuda.PLANS["made"], nn_predict_cuda.PLANS["made"])
    for _ in range(3):
        assert eng.query_device(x, q3, q_words).equal(want)
    torch.cuda.synchronize()
    assert (query_cuda.PLANS["served"], nn_predict_cuda.PLANS["served"]) \
        == (served[0] + 3, served[1] + 3)
    assert (query_cuda.PLANS["made"], nn_predict_cuda.PLANS["made"]) == made
    assert eng.counts == {"plans": 1, "served": 4}


@pytest.mark.cuda
def test_training_on_the_card_is_deterministic(dev, trained, tmp_path):
    """Two trainings from the seed on the card, one on the whole index and
    one on the same artifact loaded as a server loads it (no inv, codes
    or runs): bit-identical parameters and boundaries, the same constants
    and four windows, as the fixture's."""
    _, idx, _, srv = trained
    path = str(tmp_path / "i.stpu.npz")
    idx.save(path)
    query = SaplingIndex.load(path, skip=("inv", "codes", "lcpk_fwd",
                                          "lcpk_bwd"), mmap=True,
                              device="cuda")
    for other in (train_serving(idx.to(dev), num_chunks=8, layer_size=8,
                                epochs=150, seed=1),
                  train_serving(query, num_chunks=8, layer_size=8,
                                epochs=150, seed=1)):
        for lo, ls in zip(other.params, srv.params):
            assert all(lo[n].equal(ls[n]) for n in ("w", "b"))
        assert other.xb.equal(srv.xb)
        assert [getattr(other, f) for f in (
            "x_max", "res_min", "res_ptp", "line_m", "line_c", "most_over",
            "most_under", "max_over", "max_under", "epochs_run",
            "early_stopped")] == [getattr(srv, f) for f in (
                "x_max", "res_min", "res_ptp", "line_m", "line_c",
                "most_over", "most_under", "max_over", "max_under",
                "epochs_run", "early_stopped")]
