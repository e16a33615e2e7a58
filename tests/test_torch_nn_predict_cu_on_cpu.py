"""The CUDA source of the NN rank prediction, compiled for the CPU and held
against the plain nn_predict (NNServing.predict_ranks), rank for rank.

sapling_tpu_torch/csrc/nn_predict.cu is compiled with g++ against the
stand-in `cuda_runtime.h` of tests/csrc/cuda_mock/ (one std::thread a
lane; __dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn and __double2float_rn
plain IEEE operations), with -ffp-contract=off so that g++ fuses no
multiply and add, and with UBSan's alignment check (a 16-byte load of
shared memory at an address the card would refuse aborts the run), after
its launch is rewritten into the mock's `mock_launch`. The wrapper's own
ctypes call (ops.nn_predict_cuda.launch_nn_predict) then runs the
kernel's code on host tensors: every rank
must equal the plain PyTorch version's (itself held against sapling_tpu by
tests/test_torch_serve.py) on every k-mer of a genome with a trained
model, and on random models at edge inputs: x = 0 and x_max, x whose
scaled value is a chunk boundary, and un-scaled rows at magnitudes where a
double's step is 0.5 or 1, so that every rounding of the chain, and ties
to even, show in the rank. The card's compiler and the kernel's speed are
tested only on the card (tests/test_torch_nn_predict_cuda.py,
chip_smoke.py).
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from sapling_tpu_torch.config import IndexConfig
from sapling_tpu_torch.index.sapling import SaplingIndex
from sapling_tpu_torch.models.serve import train_serving
from sapling_tpu_torch.ops import nn_predict_cuda
from sapling_tpu_torch.ops import pack as packops
from sapling_tpu_torch.sim.genomes import uniform_genome

from .nn_cases import GROUPING, grouping_case
from .nn_cases import random_model as _random_model
from .test_torch_query_cu_on_cpu import MOCK_DIR, mock_source


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    d = tmp_path_factory.mktemp("nn_predict_cu_on_cpu")
    probe = d / "probe.cpp"
    probe.write_text("#include <barrier>\nstd::barrier<> b(1);\n")
    if subprocess.run([gxx, "-std=c++20", "-fsyntax-only", str(probe)],
                      capture_output=True).returncode != 0:
        pytest.skip("the mock needs a g++ with C++20 <barrier>")
    cpp, so = d / "nn_predict_on_cpu.cpp", d / "libnn_predict_on_cpu.so"
    with open(nn_predict_cuda.SOURCE) as f:
        cpp.write_text(mock_source(f.read(), 1))
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-Wno-unknown-pragmas",
                    "-fsanitize=alignment",
                    "-fno-sanitize-recover=alignment", "-I", MOCK_DIR,
                    "-o", str(so), str(cpp)], check=True)
    return nn_predict_cuda.bind(str(so))


def _kernel(lib, x, model):
    """The kernel through launch_nn_predict on host tensors."""
    out = torch.full((x.shape[0],), -777, dtype=torch.int64)
    args, kw = model
    rc = nn_predict_cuda.launch_nn_predict(lib, None, x, *args, out, **kw)
    assert rc == 0
    return out


def _check(lib, x, model):
    """Kernel == nn_predict on every lane; returns the ranks."""
    args, kw = model
    want = nn_predict_cuda.nn_predict(x, *args, **kw)
    got = _kernel(lib, x, model)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    return got.numpy()


def _serving_model(srv):
    """A NNServing's nn_predict arguments."""
    return ((srv.xb, srv.params[0]["w"], srv.params[0]["b"],
             srv.params[1]["w"], srv.params[1]["b"]),
            dict(x_max=srv.x_max, line_m=srv.line_m, line_c=srv.line_c,
                 res_ptp=srv.res_ptp, res_min=srv.res_min, n=srv.n))


def test_nn_kernel_source_on_every_kmer(lib):
    """tests/test_torch_serve.py's nn_setup (a 200 kbp genome, k=13, 8
    chunks of 8 units, 150 epochs): every genome k-mer's rank, and the
    serving path's own predict_ranks on the CPU is the plain version."""
    g = uniform_genome(200_000, seed=3)
    idx = SaplingIndex.build(g, IndexConfig(k=13, buckets=12), device="cpu")
    srv = train_serving(idx, num_chunks=8, layer_size=8, epochs=150, seed=1)
    x = torch.from_numpy(packops.kmers_scan(idx.codes, idx.k))
    got = _check(lib, x, _serving_model(srv))
    np.testing.assert_array_equal(got, srv.predict_ranks(x).numpy())
    assert len(np.unique(got)) > len(got) // 4


def _edge_x(model, x_max, num, seed):
    """0, x_max and its neighbours, x whose scaled float32 value equals a
    chunk boundary (and the k-mers beside them), then random x."""
    xb = model[0][0].numpy().astype(np.float64)
    at = np.round(xb * x_max).astype(np.int64)
    rng = np.random.default_rng(seed)
    x = np.concatenate([[0, 1, x_max - 1, x_max], at, at - 1, at + 1,
                        rng.integers(0, x_max + 1, num)])
    return torch.from_numpy(np.clip(x, 0, x_max))


@pytest.mark.parametrize("c,s", [(8, 16), (3, 5), (300, 41)])
def test_nn_kernel_source_random_models(lib, c, s):
    """Random models at C = 8, s = 16 and C = 3, s = 5 (parameters staged in
    shared memory) and C = 300, s = 41 (past the staging limit: read in
    place): x at the edges and on chunk boundaries; rows of rank scale
    (n = 4^13), and rows between 2^51 and 2^53 (n = 2^53), where a double
    steps by 0.5 or 1, so that many land on .5 (ties to even) and a
    rounding anywhere in the chain moves the rank."""
    x_max = 4 ** 13 - 1
    for scale, n in ((float(4 ** 13), 4 ** 13), (2.0 ** 51, 2 ** 53)):
        model = _random_model(c, s, seed=c * 100 + s, x_max=x_max,
                              scale=scale, n=n)
        x = _edge_x(model, x_max, 20_000, seed=s)
        xs = (x.numpy() / x_max).astype(np.float32)
        assert np.isin(model[0][0].numpy()[1:], xs).all()
        got = _check(lib, x, model)
        assert got.min() >= 0 and got.max() <= n - 1
        if n == 2 ** 53:
            # the plain version's rows before rounding: many on .5
            args, kw = model
            rows = nn_predict_rows(x, *args, **kw)
            assert ((rows % 1) == 0.5).sum() > 1000


@pytest.mark.parametrize("case", sorted(GROUPING))
def test_nn_kernel_source_grouping(lib, case):
    """The kernel groups each tile's lanes by chunk before the MLP: every
    rank must survive it, at rank scale and where a double steps by 0.5
    (ties to even), in every case of nn_cases.GROUPING: one chunk, every
    chunk in random and sorted order, B = 1, 31 and a tile plus one, C = 1,
    s = 1, 5, 16 and 33, the global path (C = 300 and 3000), chunks
    sharing a histogram bin (C = 2000 and 3000), every boundary in one cell
    of the chunk search's table, and x past x_max. The mock runs 2 blocks,
    so a block takes several tiles."""
    for scale, n in ((float(4 ** 13), 4 ** 13), (2.0 ** 51, 2 ** 53)):
        args, kw, x = grouping_case(case, scale, n)
        got = _check(lib, x, (args, kw))
        assert got.min() >= 0 and got.max() <= n - 1


def nn_predict_rows(x, xb, w1, b1, w2, b2, *, x_max, line_m, line_c,
                    res_ptp, res_min, n):
    """nn_predict's float64 rows before rounding (numpy, the same
    operations one by one)."""
    xs64 = x.numpy().astype(np.float64) / x_max
    xs = xs64.astype(np.float32)
    c = np.clip(np.searchsorted(xb.numpy(), xs, side="right") - 1, 0,
                xb.shape[0] - 1)
    h = np.maximum(xs.astype(np.float64)[:, None] * w1.numpy()[c, 0, :]
                   + b1.numpy()[c], 0)
    prod = h * w2.numpy()[c, :, 0]
    res = prod[:, 0]
    for j in range(1, prod.shape[1]):
        res = res + prod[:, j]
    res = res + b2.numpy()[c, 0]
    return (xs64 * line_m + line_c) - (res * res_ptp + res_min)


def test_wrapper_takes_the_plain_path_on_the_cpu():
    """nn_predict_cuda on host tensors is the plain version and launches
    nothing."""
    model = _random_model(4, 6, seed=3, x_max=4 ** 11, scale=4.0 ** 11,
                          n=4 ** 11)
    x = _edge_x(model, 4 ** 11, 500, seed=4)
    before = dict(nn_predict_cuda.LAUNCHES)
    args, kw = model
    np.testing.assert_array_equal(
        nn_predict_cuda.nn_predict_cuda(x, *args, **kw).numpy(),
        nn_predict_cuda.nn_predict(x, *args, **kw).numpy())
    assert nn_predict_cuda.LAUNCHES == before


def test_serving_plan_source(lib):
    """A serving plan (NNPredictPlan) is made once with nn_predict_cuda's
    checks of the model's arrays and then launches the kernel for each
    request's x alone (plan.launch on host tensors): every rank equal to
    the plain version's, at 10^8 ranks; a model array nn_predict_cuda
    refuses is refused when the plan is made, a request's x when it
    comes, before any launch."""
    x_max = 4 ** 21 - 1
    args, kw = _random_model(64, 16, seed=23, x_max=x_max, scale=1e8,
                             n=10 ** 8)
    made = nn_predict_cuda.PLANS["made"]
    plan = nn_predict_cuda.NNPredictPlan(*args, lib=lib, **kw)
    assert nn_predict_cuda.PLANS["made"] == made + 1
    assert all(a is b for a, b in zip(plan.arrays, args))
    for seed in (1, 2):
        x = _edge_x((args, kw), x_max, 5000, seed)
        out = torch.full((x.shape[0],), -777, dtype=torch.int64)
        assert plan.launch(None, x, out) == 0
        assert out.equal(nn_predict_cuda.nn_predict(x, *args, **kw))
    xb, w1, b1, w2, b2 = args
    for bad, message in (((xb.double(), w1, b1, w2, b2), "xb must"),
                         ((xb, w1.float(), b1, w2, b2), "w1 must"),
                         ((xb, w1, b1, w2, b2[:, :0]), "b2 must"),
                         ((xb, w1[:, :, :1].contiguous(), b1, w2, b2),
                          "b1 must"),
                         ((xb, w1, b1.t().contiguous().t(), w2, b2),
                          "b1 must")):
        with pytest.raises(ValueError, match=message):
            nn_predict_cuda.NNPredictPlan(*bad, lib=lib, **kw)
    launches = dict(nn_predict_cuda.LAUNCHES)
    for x, message in ((torch.zeros(5, dtype=torch.int32), "x must"),
                       (torch.zeros((5, 2), dtype=torch.int64), "x must"),
                       (torch.zeros(10, dtype=torch.int64)[::2], "x must"),
                       (torch.zeros(5, dtype=torch.int64, device="meta"),
                        "x is on meta")):
        with pytest.raises(ValueError, match=message):
            plan(x)
    assert nn_predict_cuda.LAUNCHES == launches
    assert nn_predict_cuda.PLANS["made"] == made + 1
