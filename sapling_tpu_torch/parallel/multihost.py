"""Multi-process orchestration: replicated index, sharded reads, ordered SAM.

The reference has no distributed anything (SURVEY.md §2: inter-tool
communication is files on disk). The port's scale-out:

  * `initialize_distributed` joins N processes into one torch.distributed
    group (NCCL for the card; gloo for the CPU, or for ranks that share
    one card, which NCCL refuses); each process builds or loads the SAME
    index artifact (read-only, on its own device);
  * the FASTQ is split into per-process shards of contiguous records
    (deterministic given the process count), each process aligns its
    shard on its device and writes SAM records only;
  * the shards concatenate in record order, so the final file is
    byte-identical to a single-process run — the reference's single-stream
    output contract, kept under data parallelism.

Without a process group this degrades to one process, shard 0 of 1.
`spawn_ranks` starts the ranks of one group on this machine.
"""

from __future__ import annotations

import os
import queue
import time
import traceback

import torch
import torch.distributed as dist


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> tuple[int, int]:
    """Join the job's process group (with no coordinator: one process, no
    group). coordinator: "host:port" (TCP) or a tcp:// or file:// URL;
    backend: "nccl" (the card, the default: each process takes card
    process_id mod the card count) or "gloo" (CPU tensors, or CUDA tensors
    of ranks that share a card). Returns (rank, world size)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not coordinator:
        return 0, 1
    backend = backend or "nccl"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def _rank_main(rank, world, init, backend, fn, args, results):
    """One spawned rank: join the group, run fn, send (rank, error, value)."""
    try:
        initialize_distributed(init, world, rank, backend)
        value = fn(rank, world, *args)
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    results.put((rank, None, value))
    dist.destroy_process_group()


def spawn_ranks(fn, world: int, init: str, backend: str | None = None,
                args: tuple = (), timeout: float = 600.0) -> list:
    """Run fn(rank, world, *args) in `world` processes started with the
    spawn method (CUDA cannot run in a forked child), joined in one group
    by initialize_distributed(init, world, rank, backend). fn must be a
    module-level function of a module the children can import. Returns
    the ranks' return values in rank order. Raises, with the failing
    rank's traceback, if a rank fails or dies, or when `timeout` seconds
    pass; every process it started has ended when it returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, init, backend, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    values = {}
    deadline = time.monotonic() + timeout
    try:
        while len(values) < world:
            try:
                rank, err, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in values]
                if dead:
                    try:    # its traceback may still be on the way
                        rank, err, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} died (exit code "
                            f"{procs[dead[0]].exitcode})") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout:.0f} s")
                else:
                    continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
            values[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [values[r] for r in range(world)]


def shard_bounds(num_records: int, num_shards: int, shard: int) -> tuple[int, int]:
    """Contiguous block shard [lo, hi) — record order preserved across the
    concatenation of shards 0..num_shards-1."""
    per = (num_records + num_shards - 1) // num_shards
    lo = min(shard * per, num_records)
    return lo, min(lo + per, num_records)


def count_fastq_records(path: str) -> int:
    """Streaming record count (4 lines per record; a truncated trailing
    record is dropped, matching the reference reader align.cpp:174-190).

    Validates the 4-line frame as it streams: every record's first line
    must start with '@' and its third with '+' — a blank or stray line
    would otherwise shift every later record boundary and split_fastq
    would silently cut records across shard files (ADVICE r3)."""
    n = 0
    with open(path, "rb") as f:
        for i, line in enumerate(f):
            r = i & 3
            if r == 0 and not line.startswith(b"@"):
                raise ValueError(
                    f"{path}:{i + 1}: malformed FASTQ — record header "
                    f"does not start with '@' (got {line[:20]!r}); "
                    "refusing to shard a frame-shifted file")
            if r == 2 and not line.startswith(b"+"):
                raise ValueError(
                    f"{path}:{i + 1}: malformed FASTQ — separator line "
                    f"does not start with '+' (got {line[:20]!r})")
            n = i + 1
    return n // 4


def split_fastq(path: str, num_shards: int, out_dir: str,
                shard: int | None = None) -> list[str]:
    """Split a FASTQ into contiguous per-shard files, streaming (O(1)
    memory, record lines copied verbatim). With `shard` given, ONLY that
    shard's file is written — each process materializes just its own
    slice instead of every process rewriting the whole input. Returns the
    deterministic path list for ALL shards either way (only the
    requested ones exist on this host)."""
    os.makedirs(out_dir, exist_ok=True)
    total = count_fastq_records(path)
    per = (total + num_shards - 1) // num_shards
    paths = [os.path.join(out_dir, f"shard{s:04d}.fq")
             for s in range(num_shards)]
    want = set(range(num_shards)) if shard is None else {shard}
    outs = {s: open(paths[s], "wb") for s in want}
    try:
        with open(path, "rb") as f:
            it = iter(f)
            for rec in range(total):
                lines = [next(it) for _ in range(4)]
                s = min(rec // per, num_shards - 1) if per else 0
                if s in outs:
                    for ln in lines:
                        outs[s].write(
                            ln if ln.endswith(b"\n") else ln + b"\n")
                elif shard is not None and s > shard:
                    break
    finally:
        for fh in outs.values():
            fh.close()
    return paths


def align_shard(index, fastq_shard: str, out_sam_body: str, cfg=None,
                device="cuda") -> None:
    """Align one shard on `device`, emitting SAM RECORDS ONLY (no header)
    so shards concatenate."""
    from ..align.aligner import SeedExtendAligner
    from ..io.fastq import read_fastq

    aligner = SeedExtendAligner(index, cfg, device=device)
    with open(out_sam_body, "w") as f:
        buf = list(read_fastq(fastq_shard))
        # 8,192-read blocks through the host/device pipeline; in-order
        # yield keeps shard bodies byte-deterministic
        blocks = (buf[lo : lo + 8192] for lo in range(0, len(buf), 8192))
        for ars in aligner.align_blocks(blocks):
            for ar in ars:
                f.write(ar.to_sam())


def merge_sam(header: str, shard_bodies: list[str], out_path: str) -> None:
    """Deterministic in-order concatenation — byte-identical to a
    single-stream run."""
    with open(out_path, "w") as f:
        f.write(header)
        for p in shard_bodies:
            with open(p) as g:
                f.write(g.read())


def align_fastq_multihost(index, fastq: str, out_sam: str, cl: str,
                          cfg=None, work_dir: str | None = None,
                          device="cuda") -> None:
    """Full multi-process FASTQ -> SAM: every rank of the default group
    aligns its shard on `device`; after a barrier the lead rank (0)
    merges. Without a group the one process does the whole file."""
    from ..align.sam import sam_header

    pid, n = ((dist.get_rank(), dist.get_world_size())
              if dist.is_initialized() else (0, 1))
    work = work_dir or (out_sam + ".shards")
    os.makedirs(work, exist_ok=True)
    shards = split_fastq(fastq, n, work, shard=pid)
    body = os.path.join(work, f"body{pid:04d}.sam")
    align_shard(index, shards[pid], body, cfg, device)
    if n > 1:
        dist.barrier()
    if pid == 0:
        bodies = [os.path.join(work, f"body{s:04d}.sam") for s in range(n)]
        merge_sam(sam_header(index.chr_ends, cl), bodies, out_sam)
