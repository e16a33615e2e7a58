"""Rank bodies of the port's multi-process tests
(tests/test_torch_sharded_index.py, test_torch_parallel.py,
test_torch_multihost.py, test_torch_no_jax.py).

Not a pytest module (no test_ prefix). The tests start these functions in
spawned gloo ranks with sapling_tpu_torch.parallel.multihost.spawn_ranks;
a spawned child imports this module, so it imports the port only, never
jax or sapling_tpu. Each function runs every case of its test file in one
world and returns what the parent compares.
"""

import numpy as np
import torch
import torch.distributed as dist


def _index(art):
    from sapling_tpu_torch.index.sapling import SaplingIndex

    torch.set_num_threads(1)
    return SaplingIndex.load(art, device="cpu")


def _meshes():
    """make_mesh per (tp, axes), each made once (creating groups is a
    collective every rank makes in the same order)."""
    from sapling_tpu_torch.parallel.mesh import make_mesh

    made = {}

    def get(tp, axes=("dp", "tp")):
        if (tp, axes) not in made:
            made[tp, axes] = make_mesh(dist.get_world_size(), tp=tp,
                                       axes=axes, device="cpu")
        return made[tp, axes]

    return get


def sharded_index_cases(rank, world, art, cases):
    """{name: positions} of IndexShardedEngine for every case; "take40"
    cases gather 40-bit SplitRanks values through make_take instead."""
    from sapling_tpu_torch.ops.query import SplitRanks, make_take
    from sapling_tpu_torch.parallel.sharded_index import IndexShardedEngine

    idx = _index(art)
    mesh = _meshes()
    out = {}
    for name, c in cases.items():
        m = mesh(c["idx"], ("dp", "idx"))
        if c["kind"] == "take40":
            vals, at = c["vals"], c["at"]
            size = -(-len(vals) // c["idx"])
            mine = vals[m.coords["idx"] * size:(m.coords["idx"] + 1) * size]
            shard = SplitRanks(
                lo=torch.from_numpy((mine & 0xFFFFFFFF).astype(np.uint32)
                                    .view(np.int32)),
                hi=torch.from_numpy((mine >> 32).astype(np.uint8)))
            take = make_take((m.groups["idx"], size))
            out[name] = take(shard, torch.from_numpy(at)).numpy()
            continue
        eng = IndexShardedEngine(idx, m, rev_storage=c["rev_storage"],
                                 use_prefix=c["use_prefix"])
        if c["kind"] == "binsearch":
            out[name] = eng.query_positions_binsearch(c["codes"])
        else:
            out[name] = eng.query_positions(
                c["codes"], adaptive_bounds=c["adaptive"])
    return out


def parallel_cases(rank, world, art, codes, errs, train):
    """Mesh shapes and group members, the dp engine, error_histogram, the
    shard_for_mesh steps, the tp collectives' gradients and the graft dry
    run, all in one world."""
    from sapling_tpu_torch import graft_entry
    from sapling_tpu_torch.models import residual
    from sapling_tpu_torch.parallel.query import (ShardedQueryEngine,
                                                  error_histogram)

    idx = _index(art)
    mesh = _meshes()
    out = {"mesh": {}, "dp": {}, "hist": {}, "train": {}, "grad": {}}
    for tp, axes in ((1, ("dp", "tp")), (2, ("dp", "tp")),
                     (4, ("dp", "idx"))):
        m = mesh(tp, axes)
        out["mesh"][tp, axes] = dict(
            shape=m.shape, coords=m.coords,
            members={a: dist.get_process_group_ranks(g)
                     for a, g in m.groups.items()})
    for tp in (1, 2):
        out["dp"][tp] = ShardedQueryEngine(idx, mesh(tp)).query_positions(
            codes)
    for name, e in errs.items():
        out["hist"][name] = error_histogram(e, mesh(1), nbins=32)

    m = mesh(2)
    for name, (init, ds) in train.items():
        tr = residual.Trainer.from_params(
            residual.params_from_numpy(init, "cpu"))
        x, y, v = residual.shard_for_mesh(tr, ds, m)
        groups = dict(tp=m.groups["tp"], dp=m.groups["dp"])
        grads = tr._grads(residual.mse_loss, tr._tensor(x), tr._tensor(y),
                          tr._tensor(v), **groups)[2]
        loss = tr.train_step(x, y, v, **groups)
        out["train"][name] = dict(
            loss=float(loss), coords=m.coords,
            params=residual.params_to_numpy(tr.params),
            grads=[{"w": grads[2 * i].numpy(), "b": grads[2 * i + 1].numpy()}
                   for i in range(len(grads) // 2)])

    # the tp collectives' gradients on a 4-rank tp group: a sum whose
    # backward is the identity, and a gather whose backward sums the
    # ranks' gradients of the gathered units and takes this rank's slice
    group = mesh(4, ("dp", "idx")).groups["idx"]
    x = torch.ones(3, dtype=torch.float64, requires_grad=True)
    residual._SumOverTp.apply((rank + 1) * x, group).sum().backward()
    out["grad"]["sum"] = x.grad.numpy()
    h = torch.full((1, 1, 2), float(rank + 1), dtype=torch.float64,
                   requires_grad=True)
    w = torch.arange(8, dtype=torch.float64) * (rank + 1)
    (residual._GatherOverTp.apply(h, group) * w).sum().backward()
    out["grad"]["gather"] = h.grad.numpy().ravel()

    out["dryrun"] = graft_entry.dryrun_multichip(world, device="cpu")
    return out


def align_multihost(rank, world, art, fq, out_sam, work):
    """align_fastq_multihost on the CPU; rank 0 writes the merged SAM."""
    from sapling_tpu_torch.config import AlignerConfig
    from sapling_tpu_torch.parallel.multihost import align_fastq_multihost

    align_fastq_multihost(_index(art), fq, out_sam, cl="x",
                          cfg=AlignerConfig(), work_dir=work, device="cpu")
    return rank


def leaked_modules(rank, world):
    """The jax / sapling_tpu modules a rank that imported the port's
    sharded serving holds (none)."""
    import sys

    import sapling_tpu_torch.graft_entry  # noqa: F401
    import sapling_tpu_torch.models.residual  # noqa: F401
    import sapling_tpu_torch.parallel.multihost  # noqa: F401
    import sapling_tpu_torch.parallel.query  # noqa: F401
    import sapling_tpu_torch.parallel.sharded_index  # noqa: F401
    import sapling_tpu_torch.tools.query_big_split  # noqa: F401

    return sorted(m for m in sys.modules
                  if m in ("jax", "optax")
                  or m.startswith(("jax.", "optax.", "sapling_tpu.")))
