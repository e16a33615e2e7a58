"""The port's index-sharded engine (sapling_tpu_torch.parallel.sharded_index)
on a world of 4 gloo CPU ranks, held exactly against sapling_tpu's
IndexShardedEngine on the same (dp, idx) mesh shape (4 of conftest's 8
virtual devices) and against the port's single-device engine: the twin
of tests/test_sharded_index.py.

The world is spawned once for the module and runs every case
(tests/torch_dist_worker.py::sharded_index_cases) while the JAX side
runs here; each case is a test of its own.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

from sapling_tpu.config import IndexConfig, QueryConfig
from sapling_tpu.index.sapling import SaplingIndex
from sapling_tpu.ops.query import SplitRanks as JaxSplitRanks
from sapling_tpu.ops.query import take_rank as jax_take_rank
from sapling_tpu.parallel.mesh import make_mesh
from sapling_tpu.parallel.sharded_index import IndexShardedEngine
from sapling_tpu.sim.genomes import repeat_genome, uniform_genome
from sapling_tpu_torch.index.sapling import SaplingIndex as PortIndex
from sapling_tpu_torch.ops.query import SplitRanks, take_rank
from sapling_tpu_torch.parallel.multihost import spawn_ranks

from . import torch_dist_worker

WORLD = 4
# name: (dp, idx, length, nq, seed, kind, rev_storage, use_prefix, adaptive)
CASES = {
    "dp1_idx4": (1, 4, 21, 512, 3, "plquery", "auto", True, False),
    "dp2_idx2": (2, 2, 21, 512, 3, "plquery", "auto", True, False),
    "dp4_idx1": (4, 1, 21, 512, 3, "plquery", "auto", True, False),
    "L11": (2, 2, 11, 256, 9, "plquery", "auto", True, False),
    "L31": (2, 2, 31, 256, 9, "plquery", "auto", True, False),
    "split": (2, 2, 21, 256, 11, "plquery", "split", True, False),
    "no_prefix": (1, 4, 21, 256, 13, "plquery", "auto", False, False),
    "binsearch": (1, 4, 21, 256, 15, "binsearch", "auto", True, False),
    "adaptive": (1, 4, 21, 256, 21, "plquery", "auto", True, True),
}


def _mixed_queries(idx, length, nq, seed):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, idx.n - length + 1, nq)
    codes = idx.codes[starts[:, None] + np.arange(length)].copy()
    # a quarter random (mostly absent -> -1 / stride-scan paths)
    codes[: nq // 4] = rng.integers(0, 4, (nq // 4, length), dtype=np.uint8)
    return codes


def _vals40():
    """4,096 wheat-scale 40-bit positions and 1,000 lanes into them."""
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 14_300_000_000, 4096).astype(np.int64)
    return vals, rng.integers(0, 4096, 1000)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX index, port index, codes per case, the world's future)."""
    d = tmp_path_factory.mktemp("sharded_index")
    # repeats up front so duplicate-rank tie-breaking is exercised
    g = np.concatenate([repeat_genome(4096, period=96, seed=7),
                        uniform_genome((1 << 14) - 4096, seed=77)])
    jidx = SaplingIndex.build(g, IndexConfig(k=21, buckets=10))
    art = str(d / "idx.stpu.npz")
    jidx.save(art)
    codes = {name: _mixed_queries(jidx, c[2], c[3], c[4])
             for name, c in CASES.items()}
    cases = {name: dict(idx=c[1], codes=codes[name], kind=c[5],
                        rev_storage=c[6], use_prefix=c[7], adaptive=c[8])
             for name, c in CASES.items()}
    vals, at = _vals40()
    cases["take40"] = dict(idx=WORLD, kind="take40", vals=vals, at=at)
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(spawn_ranks, torch_dist_worker.sharded_index_cases,
                        WORLD, f"file://{d / 'rendezvous'}", "gloo",
                        (art, cases), 300)
        yield jidx, PortIndex.load(art, device="cpu"), codes, fut


def _ranks(world):
    """Every rank's results; the ranks must agree."""
    res = world[3].result()
    for other in res[1:]:
        assert other.keys() == res[0].keys()
        for name in res[0]:
            np.testing.assert_array_equal(other[name], res[0][name])
    return res[0]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_parity(world, name):
    jidx, pidx, codes, _ = world
    dp, nidx, _length, _nq, _seed, kind, storage, use_prefix, adaptive = \
        CASES[name]
    codes = codes[name]
    eng = IndexShardedEngine(
        jidx, make_mesh(dp * nidx, tp=nidx, axes=("dp", "idx")),
        rev_storage=storage, use_prefix=use_prefix)
    if kind == "binsearch":
        want = eng.query_positions_binsearch(codes)
        single = pidx.query_positions_binsearch(codes)
    else:
        want = eng.query_positions(codes, adaptive_bounds=adaptive)
        single = pidx.query_positions(
            codes, QueryConfig(adaptive_bounds=adaptive))
    got = _ranks(world)[name]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)


def test_sharded_take_40bit(world):
    """make_take over 4 rank-range shards of SplitRanks reassembles
    positions above 2^32 exactly."""
    vals, at = _vals40()
    np.testing.assert_array_equal(_ranks(world)["take40"], vals[at])


def test_split_ranks_40bit_values():
    """take_rank on SplitRanks on one device, against sapling_tpu's."""
    import torch

    vals, at = _vals40()
    lo = (vals & 0xFFFFFFFF).astype(np.uint32)
    hi = (vals >> 32).astype(np.uint8)
    got = take_rank(SplitRanks(lo=torch.from_numpy(lo.view(np.int32)),
                               hi=torch.from_numpy(hi)),
                    torch.from_numpy(at)).numpy()
    want = np.asarray(jax_take_rank(
        JaxSplitRanks(lo=jnp.asarray(lo), hi=jnp.asarray(hi)),
        jnp.asarray(at)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vals[at])
