"""A process grid for data-parallel and index-sharded query scale-out.

The reference is single-threaded, single-process CPU code with no
parallelism of any kind (SURVEY.md §2). The port scales out over
torch.distributed with one process a rank, each holding its own tensors
on its own device: the W ranks of the initialised default group form a
2-D grid W = rows x cols, rank r at row r // cols and column r % cols.
The first axis ("dp") shards query lanes, the second either the residual
trainer's hidden units ("tp") or the index's rank ranges ("idx",
parallel.sharded_index). Each axis has a process group per line of the
grid: a rank's "dp" group is its column (the ranks that differ from it
only in the dp coordinate), its "tp" / "idx" group its row.

JAX's `replicated` and `dp_sharded` shardings have no counterpart:
placement is per process. A replicated array is one every rank puts on its
own device; a dp-sharded one is the slice of the rank's dp coordinate.

The collectives go through all_reduce and all_gather here, which count
them in COLLECTIVES (read by measurement scripts, reset by the caller).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

# collectives issued since the caller last reset them
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the grid: the size and this rank's coordinate on
    each axis, the process group of each axis, and the device the mesh's
    own tensors go to (error_histogram's counts)."""

    shape: dict        # axis name -> size, in axis order (as JAX's)
    coords: dict       # axis name -> this rank's coordinate
    groups: dict       # axis name -> ProcessGroup along that axis
    device: torch.device


def make_mesh(n_devices: int | None = None, tp: int = 1,
              axes: tuple[str, str] = ("dp", "tp"),
              device="cuda") -> Mesh:
    """A 2-D grid over the n_devices ranks of the initialised default group
    (every rank of it: one process a device).

    tp is the size of the second axis and divides n_devices; the first
    axis gets n_devices // tp. Default axis names ("dp", "tp") serve the
    data-parallel query engine and the residual-MLP trainer; pass
    axes=("dp", "idx") for the index-sharded engine. Creating a group is
    a collective: every rank calls make_mesh, and every rank creates every
    row's and every column's group, rows first, in one fixed order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.multihost.initialize_distributed)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"requested {n} devices; the mesh spans every "
                         f"rank of the group, which has {world}")
    if n % tp:
        raise ValueError(f"{axes[1]}={tp} must divide n_devices={n}")
    rows = n // tp
    row, col = divmod(dist.get_rank(), tp)
    groups = {}
    for i in range(rows):
        g = dist.new_group([i * tp + j for j in range(tp)])
        if i == row:
            groups[axes[1]] = g
    for j in range(tp):
        g = dist.new_group([i * tp + j for i in range(rows)])
        if j == col:
            groups[axes[0]] = g
    return Mesh(shape={axes[0]: rows, axes[1]: tp},
                coords={axes[0]: row, axes[1]: col}, groups=groups,
                device=torch.device(device))


def pad_to_multiple(a: np.ndarray, multiple: int, fill) -> tuple[np.ndarray, int]:
    """Pad axis 0 up to a multiple (shards must be equal-sized). Returns
    (padded, original_length)."""
    b = a.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return a, b
    pad = np.full((rem,) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad]), b


def dp_slice(b: int, mesh: Mesh, dp_axis: str = "dp") -> slice:
    """This rank's lanes of a batch of b lanes (a multiple of the dp size)."""
    per = b // mesh.shape[dp_axis]
    d = mesh.coords[dp_axis]
    return slice(d * per, (d + 1) * per)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` in place over `group`; returns it."""
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors concatenated along axis 0, in group-rank order."""
    COLLECTIVES["all_gather"] += 1
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.cat(out)
