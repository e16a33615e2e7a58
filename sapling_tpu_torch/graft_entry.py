"""Entry points of the port: a single-device query check and a multi-rank
dry run (the twins of the JAX package's `__graft_entry__.py`).

entry(device)            -> (fn, example_args): the flagship forward step,
                            a batched PWL suffix-array query (predict ->
                            escalating error window -> binary search),
                            ops.query_cuda.plquery_cuda (the plquery
                            kernel on the card, one launch a call) with
                            its arguments on `device`.
dryrun_multichip(n, dev) -> inside an initialised process group of n
                            ranks: the dp-sharded query step, the
                            index-sharded query step (rank-range shards,
                            all_reduce-combined probes, split 40-bit rank
                            storage) on a ("dp", "idx") mesh, the
                            error_histogram reduction, and one dp/tp
                            sharded training step of the stacked
                            residual-MLP family, on tiny shapes.
"""

from __future__ import annotations

import numpy as np


def _tiny_index(n_bases: int = 1 << 14, k: int = 21, device="cuda"):
    from .config import IndexConfig
    from .index.sapling import SaplingIndex
    from .sim.genomes import uniform_genome

    genome = uniform_genome(n_bases, seed=4242)
    return SaplingIndex.build(genome, IndexConfig(k=k, buckets=10),
                              device=device)


def _query_codes(idx, nq: int, length: int, rng) -> np.ndarray:
    starts = rng.integers(0, idx.n - length + 1, nq)
    return idx.codes[starts[:, None] + np.arange(length)]


def entry(device="cuda"):
    import functools

    import torch

    from .ops.query_cuda import plquery_cuda

    length = 21
    idx = _tiny_index(device=device)
    codes2d = _query_codes(idx, nq=4096, length=length,
                           rng=np.random.default_rng(5))
    t = idx.table
    dev = idx.device_arrays()
    fn = functools.partial(
        plquery_cuda,
        n=idx.n, length=length, k=idx.k, buckets=idx.buckets,
        most_over=t.most_over, most_under=t.most_under,
        max_over=t.max_over, max_under=t.max_under,
    )
    x = torch.from_numpy(idx.kmerize_batch(codes2d)).to(idx.device)
    example_args = (dev["packed"], dev["rev"], dev["xlist"], dev["ylist"],
                    idx.query_words(codes2d), x)
    return fn, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run on every rank of an initialised group of n_devices ranks
    (parallel.multihost.initialize_distributed); raises on a failed check.
    Returns what it checked, for the caller to print."""
    from .models import residual
    from .ops.pack import kmers_scan
    from .parallel.mesh import make_mesh
    from .parallel.query import ShardedQueryEngine, error_histogram
    from .parallel.sharded_index import IndexShardedEngine

    tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, tp=tp, device=device)

    # --- dp-sharded query step (the serving path) ---------------------------
    idx = _tiny_index(n_bases=1 << 13, device=device)
    eng = ShardedQueryEngine(idx, mesh)
    rng = np.random.default_rng(11)
    codes2d = _query_codes(idx, nq=256, length=21, rng=rng)
    pos = eng.query_positions(codes2d)
    ok = idx.verify_hits(codes2d, pos)
    if not ok.all():
        raise AssertionError(
            f"sharded query self-check failed: {int(ok.sum())}/256")

    # --- index-sharded query step (rev/prefix arrays sharded by rank range
    # over "idx", probes combined by all_reduce) ----------------------------
    nidx = n_devices // tp
    imesh = make_mesh(n_devices, tp=nidx, axes=("dp", "idx"), device=device)
    ieng = IndexShardedEngine(idx, imesh, rev_storage="split")
    ipos = ieng.query_positions(codes2d)
    if not np.array_equal(ipos, pos):
        raise AssertionError("index-sharded parity failed")

    # --- collective statistics reduction ------------------------------------
    errs = rng.integers(-50, 50, 1000)
    hist = error_histogram(errs, mesh, nbins=16)
    if int(hist.sum()) != 1000:
        raise AssertionError(f"histogram holds {int(hist.sum())} of 1000")

    # --- dp/tp-sharded training step (stacked residual-MLP family) ----------
    kmers = kmers_scan(idx.codes, idx.k)
    ranks = np.asarray(idx.inv[: kmers.shape[0]])
    ds = residual.prepare_dataset(kmers, ranks,
                                  num_chunks=mesh.shape["dp"] * 2)
    trainer = residual.Trainer.create(0, num_chunks=ds.x.shape[0],
                                      layer_size=2 * tp, device=device)
    x, y, v = residual.shard_for_mesh(trainer, ds, mesh)
    loss = float(trainer.train_step(x, y, v, tp=mesh.groups["tp"],
                                    dp=mesh.groups["dp"]))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite training loss {loss}")
    return dict(mesh=dict(mesh.shape), imesh=dict(imesh.shape),
                query=int(ok.sum()), hist=int(hist.sum()), loss=loss)
