"""The baseline entry: the suffix array's binary search over prepared
device query words (`SaplingIndex.query_words`, then
`SaplingIndex.binsearch_device`)."""

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
    """Make the device arrays the calls read."""
    index.device_arrays()


def prepare(index, rows, pool):
    """The device query words of a batch of query codes (uint8 [B, L]),
    packed in chunks on the executor `pool`."""
    return torch.cat(list(pool.map(
        index.query_words, (rows[i:i + CHUNK]
                            for i in range(0, rows.shape[0], CHUNK)))),
        dim=1)


def call(index, inputs, length: int):
    """One request: int64 [B] positions on the index's device."""
    return index.binsearch_device(inputs, length)
