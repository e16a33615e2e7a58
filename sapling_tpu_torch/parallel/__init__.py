"""Sharded serving on torch.distributed: one process a rank (mesh), the
data-parallel query engine (query), the index-sharded engine
(sharded_index) and multi-process FASTQ -> SAM (multihost)."""
