"""The port's data-parallel serving and sharded training on a world of 4 gloo
CPU ranks, held against sapling_tpu/parallel/ on the same mesh shapes (4
of conftest's 8 virtual devices): mesh shapes and group members, the dp
engine, error_histogram, the shard_for_mesh step (within 1e-12 of the
port's one-rank step and of JAX's dp/tp step), the gradients of the tp
collectives, and the graft entry pair. The twin of tests/test_parallel.py.

The world is spawned once for the module and runs every case
(tests/torch_dist_worker.py::parallel_cases) while the JAX side runs
here.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from sapling_tpu.config import IndexConfig
from sapling_tpu.index.sapling import SaplingIndex
from sapling_tpu.models import residual as jax_residual
from sapling_tpu.ops.pack import kmers_scan
from sapling_tpu.parallel.mesh import make_mesh
from sapling_tpu.parallel.query import ShardedQueryEngine, error_histogram
from sapling_tpu.sim.genomes import uniform_genome
from sapling_tpu_torch import graft_entry
from sapling_tpu_torch.index.sapling import SaplingIndex as PortIndex
from sapling_tpu_torch.models import residual
from sapling_tpu_torch.parallel.mesh import pad_to_multiple
from sapling_tpu_torch.parallel.multihost import spawn_ranks

from . import torch_dist_worker

WORLD = 4
ERRS = {"5000": 5000, "4999_padded": 4999}
HIDDEN = (1, 2)
TRAIN_ATOL = 1e-12


def _errs(n):
    return np.random.default_rng(0).integers(-100, 100, n)


def _jax_init(hidden_layers):
    """JAX's initial parameters of 4 chunks of 4 units."""
    tr = jax_residual.Trainer.create(jax.random.PRNGKey(0), num_chunks=4,
                                     layer_size=4,
                                     hidden_layers=hidden_layers)
    return [{k: np.asarray(v) for k, v in layer.items()}
            for layer in tr.params]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX index, port index, codes, datasets, the world's future)."""
    d = tmp_path_factory.mktemp("parallel")
    jidx = SaplingIndex.build(uniform_genome(20_000, seed=77),
                              IndexConfig(k=21, buckets=8))
    art = str(d / "idx.stpu.npz")
    jidx.save(art)
    length = 21
    starts = np.random.default_rng(3).integers(0, jidx.n - length + 1,
                                                1000)  # not dp-divisible
    codes = jidx.codes[starts[:, None] + np.arange(length)]
    kmers = kmers_scan(jidx.codes, 21)
    ranks = np.asarray(jidx.inv[: kmers.shape[0]])
    ds = (jax_residual.prepare_dataset(kmers, ranks, 4),
          residual.prepare_dataset(kmers, ranks, 4))
    train = {h: (_jax_init(h), ds[1]) for h in HIDDEN}
    errs = {name: _errs(n) for name, n in ERRS.items()}
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(spawn_ranks, torch_dist_worker.parallel_cases,
                        WORLD, f"file://{d / 'rendezvous'}", "gloo",
                        (art, codes, errs, train), 300)
        yield jidx, PortIndex.load(art, device="cpu"), codes, ds, fut


def _ranks(world):
    return world[4].result()


def test_pad_to_multiple():
    a = np.arange(10)
    p, b = pad_to_multiple(a, 8, 0)
    assert p.shape[0] == 16 and b == 10
    p2, b2 = pad_to_multiple(a, 5, 0)
    assert p2 is a or p2.shape[0] == 10


@pytest.mark.parametrize("tp,axes", [(1, ("dp", "tp")), (2, ("dp", "tp")),
                                     (4, ("dp", "idx"))])
def test_mesh_shape_and_groups(world, tp, axes):
    """JAX's mesh shape; a rank's groups are its row and column of JAX's
    device grid (rank r is device r)."""
    jmesh = make_mesh(WORLD, tp=tp, axes=axes)
    grid = np.vectorize(lambda dv: dv.id)(jmesh.devices)
    for r, res in enumerate(_ranks(world)):
        m = res["mesh"][tp, axes]
        assert m["shape"] == dict(jmesh.shape)
        row, col = np.argwhere(grid == jax.devices()[r].id)[0]
        assert m["coords"] == {axes[0]: row, axes[1]: col}
        assert m["members"][axes[1]] == list(range(row * tp, row * tp + tp))
        assert m["members"][axes[0]] == list(range(col, WORLD, tp))


@pytest.mark.parametrize("tp", [1, 2])
def test_sharded_query_matches_single_device(world, tp):
    jidx, pidx, codes, _ds, _ = world
    want = ShardedQueryEngine(jidx, make_mesh(WORLD, tp=tp)).query_positions(
        codes)
    np.testing.assert_array_equal(want, pidx.query_positions(codes))
    for res in _ranks(world):
        np.testing.assert_array_equal(res["dp"][tp], want)
    assert pidx.verify_hits(codes, want).all()


def test_sharded_query_refuses_pred2(world):
    from sapling_tpu_torch.parallel.query import ShardedQueryEngine as Port

    with pytest.raises(ValueError, match="TPU workaround"):
        Port(world[1], mesh=None, use_pred2=True)


@pytest.mark.parametrize("name", list(ERRS))
def test_error_histogram(world, name):
    """Against numpy's bincount and JAX's error_histogram. When the errors
    do not divide by dp, JAX's raises: it subtracts the padding from bin 0
    of np.asarray of a jax Array, which is read-only."""
    errs = _errs(ERRS[name])
    lo, hi = int(errs.min()), int(errs.max()) + 1
    width = max(1, (hi - lo + 31) // 32)
    ref = np.bincount(np.clip((errs - lo) // width, 0, 31), minlength=32)
    if len(errs) % WORLD:
        with pytest.raises(ValueError, match="read-only"):
            error_histogram(errs, make_mesh(WORLD), nbins=32)
    else:
        np.testing.assert_array_equal(
            error_histogram(errs, make_mesh(WORLD), nbins=32), ref)
    for res in _ranks(world):
        np.testing.assert_array_equal(res["hist"][name], ref)


def _assemble(ranks, name, what="params"):
    """The whole parameter (or gradient) stack from the (dp, tp) ranks'
    shards."""
    shards = {(r["train"][name]["coords"]["dp"],
               r["train"][name]["coords"]["tp"]): r["train"][name][what]
              for r in ranks}
    ndp = 1 + max(d for d, _ in shards)
    ntp = 1 + max(t for _, t in shards)
    depth = len(shards[0, 0])
    whole = []
    for i in range(depth):
        axis_w, axis_b = (2, 1) if i < depth - 1 else (1, None)
        layer = {}
        for key, axis in (("w", axis_w), ("b", axis_b)):
            rows = []
            for d in range(ndp):
                parts = [shards[d, t][i][key] for t in range(ntp)]
                rows.append(parts[0] if axis is None
                            else np.concatenate(parts, axis=axis))
            layer[key] = np.concatenate(rows, axis=0)
        whole.append(layer)
    return whole


@pytest.mark.parametrize("hidden_layers", HIDDEN)
def test_shard_for_mesh_step(world, hidden_layers):
    """One dp=2 x tp=2 step from JAX's initial parameters: loss and every
    parameter within 1e-12 of the port's one-rank step and of JAX's own
    dp/tp step."""
    jds, pds = world[3]
    init = _jax_init(hidden_layers)

    one = residual.Trainer.from_params(residual.params_from_numpy(init,
                                                                  "cpu"))
    one_grads = one._grads(residual.mse_loss, *(
        one._tensor(a, dt) for a, dt in ((pds.x, None), (pds.res, None),
                                         (pds.valid, torch.float32))))[2]
    one_loss = float(one.train_step(pds.x, pds.res, pds.valid))
    one_params = residual.params_to_numpy(one.params)

    jtr = jax_residual.Trainer.create(jax.random.PRNGKey(0), num_chunks=4,
                                      layer_size=4,
                                      hidden_layers=hidden_layers)
    x, y, v = jax_residual.shard_for_mesh(jtr, jds, make_mesh(WORLD, tp=2))
    jparams, _opt, jloss = jtr.train_step()(jtr.params, jtr.opt_state, x, y,
                                            v)

    ranks = _ranks(world)
    # Adam's first step moves each parameter by ~lr whatever its gradient's
    # scale, so the gradients are held to the one-rank step's directly
    grads = _assemble(ranks, hidden_layers, "grads")
    for i, layer in enumerate(grads):
        for j, key in enumerate(("w", "b")):
            np.testing.assert_allclose(layer[key],
                                       one_grads[2 * i + j].numpy(),
                                       rtol=0, atol=TRAIN_ATOL)
    got = _assemble(ranks, hidden_layers)
    for r in ranks:
        loss = r["train"][hidden_layers]["loss"]
        np.testing.assert_allclose(loss, one_loss, rtol=0, atol=TRAIN_ATOL)
        np.testing.assert_allclose(loss, float(jloss), rtol=0,
                                   atol=TRAIN_ATOL)
    for i, layer in enumerate(got):
        for key in ("w", "b"):
            np.testing.assert_allclose(layer[key], one_params[i][key],
                                       rtol=0, atol=TRAIN_ATOL)
            np.testing.assert_allclose(layer[key],
                                       np.asarray(jparams[i][key]), rtol=0,
                                       atol=TRAIN_ATOL)


@pytest.mark.parametrize("op", ["sum", "gather"])
def test_tp_collective_gradients(world, op):
    """The tp sum's backward is the identity: rank r's gradient of
    sum(y), y the tp sum of (r+1)*x, is r+1 (torch.distributed.nn's
    all_reduce would give 4*(r+1)). The tp gather's backward sums the
    ranks' gradients of the gathered units: rank r's [1,1,2] units in a
    loss sum_r' <H, w_r'>, w_r' = (r'+1)*arange(8), get 10*arange(8)
    [2r:2r+2]."""
    for r, res in enumerate(_ranks(world)):
        want = (np.full(3, r + 1.0) if op == "sum"
                else 10.0 * np.arange(8)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(res["grad"][op], want)


def test_graft_entry_matches_jax():
    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args).numpy()
    assert out.shape == tuple(args[-1].shape)  # one position per query
    assert out.min() >= 0  # all sampled queries must be found
    jfn, jargs = jax_graft.entry()
    np.testing.assert_array_equal(out, np.asarray(jax.jit(jfn)(*jargs)))


def test_graft_dryrun_multichip(world):
    for res in _ranks(world):
        got = res["dryrun"]
        assert got["mesh"] == {"dp": 2, "tp": 2}
        assert got["imesh"] == {"dp": 2, "idx": 2}
        assert got["query"] == 256 and got["hist"] == 1000
        assert np.isfinite(got["loss"])
