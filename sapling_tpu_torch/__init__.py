"""sapling_tpu_torch: the PyTorch / CUDA port of sapling_tpu.

The same learned suffix-array index and seed-and-extend aligner as the JAX
package `sapling_tpu`, with the same module names, on PyTorch tensors: the
query and the Smith-Waterman passes run on the device the index and the
aligner are given (`SaplingIndex.build/load/from_fasta(..., device=)`,
`SaplingIndex.to(device)`, `SeedExtendAligner(..., device=)`): the card
("cuda") unless the caller asks for "cpu", with hand-written CUDA kernels
for Smith-Waterman (ops/sw_cuda.py, csrc/sw.cu). Host-side code (FASTA/FASTQ, artifacts,
the native SA-IS / Kasai / traceback library, the PWL build) is numpy and
C++, as in the JAX package. This package never imports jax.
"""

from .config import AlignerConfig, IndexConfig, QueryConfig, SaplingConfig
from .index.sapling import SaplingIndex
from .io.fasta import Genome, read_fasta

__all__ = [
    "AlignerConfig",
    "Genome",
    "IndexConfig",
    "QueryConfig",
    "SaplingConfig",
    "SaplingIndex",
    "read_fasta",
]
