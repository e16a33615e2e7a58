"""Exercise a split-limb (format-v4) index end to end on idx x dp ranks
(PyTorch port; the twin of tools/query_big_split.py).

    python -m sapling_tpu_torch.tools.query_big_split <index.stpu.npz>
        [nq=200000] [idx=4] [dp=2] [force_small=0] [single=1]
        [device=cuda] [backend=nccl|gloo]

The tool starts its idx * dp ranks itself (parallel.multihost.spawn_ranks,
the spawn start method, a file:// rendezvous in a temporary directory).
Each rank loads the artifact memory-mapped (rev limbs stay 5 B/rank on
the host, codes copied into RAM) and runs on `device`: the card (rank r
on card r mod the card count; NCCL by default, which needs a card a rank)
or the CPU (gloo). backend=gloo lets several ranks share one card.

Checks, in order:
  1. loads the split artifact (rev limbs stay 5 B/rank host-side);
  2. IndexShardedEngine over a ("dp", "idx") mesh queries nq random
     k-mers; every hit self-checked by substring equality (the
     reference's correctness criterion, sapling_example.cpp:143-154);
     the query runs twice and the second call is timed (host clock, the
     positions copied back) with the collectives it issued;
  3. a biased sample drawn from positions > 2^32 must return hi-limb
     nonzero positions exactly (the limb path does real work);
  4. rank 0's single-device run of the whole index (rev reassembled into
     int64) for cross-parity with the sharded engine, timed the same way;
  5. prints the device bytes a rank of the sharded layout holds, replicated
     and sharded, against an 80 GB card.
force_small=1 drops the checks that need n > 2^32 (a smoke-test mode).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

CARD_BYTES = 80e9   # one H100 80GB's memory


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _tensor_bytes(*ts) -> int:
    total = 0
    for t in ts:
        for part in (t if isinstance(t, tuple) else (t,)):
            if part is not None:
                total += part.numel() * part.element_size()
    return total


def _rank(rank, world, path, nq, n_idx, small, single, device):
    """One rank's checks; returns the lines rank 0 prints."""
    import torch

    from ..parallel.mesh import COLLECTIVES, make_mesh
    from ..parallel.sharded_index import IndexShardedEngine
    from .bench_query_scale import load_for_queries

    dev = (torch.device("cpu") if device == "cpu"
           else torch.device("cuda", rank % torch.cuda.device_count()))
    lines = []
    t0 = time.perf_counter()
    idx = load_for_queries(path, dev)
    if idx.rev_hi is None:
        raise ValueError(f"{path}: not a split-limb (v4) artifact")
    t = idx.table
    lines.append(
        f"loaded n={idx.n:,} buckets=2^{idx.buckets} "
        f"most=({t.most_over},{t.most_under}) "
        f"max=({t.max_over},{t.max_under}) in {time.perf_counter()-t0:.1f}s;"
        f" {np.count_nonzero(idx.rev_hi != 0):,} ranks have hi != 0")
    if not small and not (idx.n > 0xFFFFFFFF and (idx.rev_hi != 0).any()):
        raise AssertionError("hi limbs are all zero — this run would not "
                             "prove anything")

    k = idx.k
    rng = np.random.default_rng(7)
    # half uniform, half drawn beyond 2^32 so hi-limb reassembly is load-
    # bearing for the answer, not just exercised
    hi_floor = 0 if small else 1 << 32
    s_uni = rng.integers(0, idx.n - k + 1, nq // 2)
    s_hi = rng.integers(hi_floor, idx.n - k + 1, nq - nq // 2)
    starts = np.concatenate([s_uni, s_hi])
    codes2d = idx.codes[starts[:, None] + np.arange(k)]

    mesh = make_mesh(world, tp=n_idx, axes=("dp", "idx"), device=dev)
    lines.append(f"mesh: {mesh.shape} over {world} ranks on {dev.type}")
    eng = IndexShardedEngine(idx, mesh)
    pos, first_s = _timed(lambda: eng.query_positions(codes2d))
    COLLECTIVES.update(all_reduce=0, all_gather=0)
    again, s = _timed(lambda: eng.query_positions(codes2d))
    if not np.array_equal(again, pos):
        raise AssertionError("the sharded engine's two calls differ")
    lines.append(
        f"sharded query: {nq} lanes in {s:.3f} s = {nq / s:.1f} q/s "
        f"(second call; the first {first_s:.3f} s); collectives a call "
        f"{COLLECTIVES}")
    good = idx.verify_hits(codes2d, pos)
    lines.append(f"self-check: {int(good.sum())}/{nq}")
    if not good.all():
        raise AssertionError("sharded self-check FAILED")
    hi_out = pos[nq // 2:] >> 32
    lines.append(f"positions with hi limb nonzero: "
                 f"{int((pos >> 32 != 0).sum()):,}/{nq}")
    if not small and not (hi_out != 0).any():
        raise AssertionError("no returned position exercised the limb")

    if single and rank == 0:
        idx.query_positions(codes2d)
        pos1, s1 = _timed(lambda: idx.query_positions(codes2d))
        lines.append(f"single-device query: {s1:.3f} s = {nq / s1:.1f} q/s"
                     " (second call)")
        if not np.array_equal(pos1, pos):
            raise AssertionError("sharded vs single-device positions differ")
        lines.append("sharded == single-device: exact")

    rep = _tensor_bytes(eng.packed, eng.xlist, eng.ylist, eng.bounds)
    shd = _tensor_bytes(eng.rev, eng.prefix, eng.prefix3)
    lines.append(
        f"device bytes a rank at idx={n_idx}: replicated {rep:,} (packed "
        f"genome as int64 words + PWL table) + sharded rev {shd:,} = "
        f"{rep + shd:,} ({100 * (rep + shd) / CARD_BYTES:.3f}% of an 80 GB "
        f"card; one device's rev alone would be {shd * n_idx:,})")
    return lines


def main(argv):
    from ..config import parse_keyval_args
    from ..parallel.multihost import spawn_ranks

    if len(argv) < 2:
        print(__doc__)
        return 1
    kv = parse_keyval_args(argv[2:])
    nq = int(kv.get("nq", 200_000))
    n_idx = int(kv.get("idx", 4))
    n_dp = int(kv.get("dp", 2))
    device = kv.get("device", "cuda")
    backend = kv.get("backend", "nccl" if device == "cuda" else "gloo")
    small = bool(int(kv.get("force_small", 0)))  # smoke-test mode only
    single = bool(int(kv.get("single", 1)))
    world = n_idx * n_dp
    with tempfile.TemporaryDirectory(prefix="query_big_split_") as td:
        init = "file://" + os.path.join(td, "rendezvous")
        lines = spawn_ranks(
            _rank, world, init, backend,
            args=(os.path.abspath(argv[1]), nq, n_idx, small, single,
                  device), timeout=3600)[0]
    print(f"{world} ranks ({backend}, {device})")
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
