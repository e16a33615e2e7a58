"""The lookup entry: plQuery over prepared device inputs
(`SaplingIndex.query_inputs`, then `SaplingIndex.query_device`)."""

from __future__ import annotations

import torch

# rows the program packs at a time in set-up, on the harness's threads
CHUNK = 1 << 18


def build() -> None:
    """Build the program's query kernels (a first run compiles them)."""
    from sapling_tpu_torch.ops import query_cuda
    from sapling_tpu_torch.ops.sw_cuda import build_kernel
    build_kernel(query_cuda.SOURCE)


def ready(index) -> None:
    """Make the device arrays and record tables the calls read."""
    index.device_arrays()
    index.query_records()


def prepare(index, rows, pool):
    """The device inputs of a batch of query codes (uint8 [B, L]), packed
    in chunks on the executor `pool`."""
    parts = list(pool.map(index.query_inputs,
                          (rows[i:i + CHUNK]
                           for i in range(0, rows.shape[0], CHUNK))))
    x = torch.cat([p[0] for p in parts])
    q3 = None if parts[0][1] is None else torch.cat([p[1] for p in parts])
    words = (None if parts[0][2] is None
             else torch.cat([p[2] for p in parts], dim=1))
    return x, q3, words


def call(index, inputs, length: int):
    """One request: int64 [B] positions on the index's device."""
    return index.query_device(*inputs, length)
