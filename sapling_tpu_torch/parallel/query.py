"""Data-parallel sharded query execution.

The equivalent of running N independent copies of the reference's
single-threaded query loop (reference: src/sapling_example.cpp:133-141):
every rank holds the whole index on its own device, query lanes shard
over the mesh's "dp" axis, and each rank runs the same predict -> window
-> masked-binary-search cascade (ops.query.plquery_batch) on its own
slice with no collective inside the query (ops.query_cuda.plquery_cuda:
the plquery kernel on the card). One all_gather over "dp" returns every rank's positions;
the statistics reductions (error histograms) are one all_reduce.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import pack as packops
from ..ops.query_cuda import plquery_cuda
from .mesh import Mesh, all_gather, all_reduce, dp_slice, pad_to_multiple


def pack_lanes(index, codes2d: np.ndarray, mesh: Mesh, use3: bool,
               dp_axis: str = "dp"):
    """This rank's dp slice of a [B, L] batch padded to a multiple of the
    dp size with all-A lanes (whose outputs are dropped), packed on the
    host and sent to index.device: (x int64 [b], q3 int64 [b] or None,
    q_words int64 [ceil(L/16), b] or None, B), as
    SaplingIndex.query_inputs packs them (q3 for the fast3 probe, else
    q_words)."""
    ndp = mesh.shape[dp_axis]
    x, b = pad_to_multiple(packops.batch_kmers_adjusted(codes2d, index.k),
                           ndp, 0)
    mine = dp_slice(x.shape[0], mesh, dp_axis)
    dev = index.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    q3 = q_words = None
    if use3:
        q3p, _ = pad_to_multiple(packops.pack_queries3(codes2d), ndp, 0)
        q3 = put(q3p[mine].view(np.int64))
    else:
        qw, _ = pad_to_multiple(
            np.ascontiguousarray(packops.pack_queries(codes2d).T), ndp, 0)
        q_words = put(qw[mine].T.astype(np.int64))
    return put(x[mine]), q3, q_words, b


def gather_lanes(pos: torch.Tensor, mesh: Mesh, b: int,
                 dp_axis: str = "dp") -> np.ndarray:
    """Every dp rank's positions, in lane order, padding dropped."""
    return all_gather(pos, mesh.groups[dp_axis]).cpu().numpy()[:b]


class ShardedQueryEngine:
    """The whole index on every rank's device + dp-sharded query batches.

    Equivalent role to one `Sapling` struct shared by N workers: the index
    arrays are the index's own device arrays (SaplingIndex.device_arrays,
    on index.device), and each query_positions call runs this rank's
    slice of the batch. The JAX engine's use_pred2 (a two-gather
    prediction kept as a TPU flag) is not ported."""

    def __init__(self, index, mesh: Mesh, use_pred2: bool = False):
        if use_pred2:
            raise ValueError("use_pred2 is a TPU workaround (a two-gather "
                             "prediction for the TPU's gather throughput) "
                             "and is not ported")
        self.index = index
        self.mesh = mesh

    def query_inputs(self, codes2d: np.ndarray):
        """(x, q3, q_words, B): this rank's lanes of a [B, L] batch on
        index.device (pack_lanes)."""
        length = int(codes2d.shape[1])
        # the card's kernel has no fast3 probe (SaplingIndex.query_inputs)
        use3 = (self.index.device.type == "cpu"
                and self.index.prefix3 is not None
                and length <= min(self.index.k, packops.P3_BASES))
        return pack_lanes(self.index, codes2d, self.mesh, use3)

    def query_device(self, x, q3, q_words, length: int,
                     max_stride_steps: int = 1 << 20) -> torch.Tensor:
        """This rank's lanes' positions (int64, on index.device) over
        prepared inputs; no collective."""
        idx = self.index
        dev = idx.device_arrays()
        t = idx.table
        bucket_recs, rank_recs = idx.query_records()
        return plquery_cuda(
            dev["packed"], dev["rev"], dev["xlist"], dev["ylist"], q_words,
            x, dev["prefix64"], dev["prefix3"], q3, n=idx.n, length=length,
            k=idx.k, buckets=idx.buckets, most_over=t.most_over,
            most_under=t.most_under, max_over=t.max_over,
            max_under=t.max_under, max_stride_steps=max_stride_steps,
            bucket_recs=bucket_recs, rank_recs=rank_recs)

    def query_positions(self, codes2d: np.ndarray,
                        max_stride_steps: int = 1 << 20) -> np.ndarray:
        """[B, L] base codes -> [B] genome positions, dp-sharded; on every
        rank, equal to index.query_positions."""
        x, q3, q_words, b = self.query_inputs(codes2d)
        pos = self.query_device(x, q3, q_words, int(codes2d.shape[1]),
                                max_stride_steps)
        return gather_lanes(pos, self.mesh, b)


def error_histogram(errors: np.ndarray, mesh: Mesh, nbins: int = 64,
                    lo: int | None = None, hi: int | None = None) -> np.ndarray:
    """Distributed histogram of signed prediction errors: each dp rank
    counts its slice on mesh.device, then one all_reduce over "dp" (the
    reference gathers the same statistics serially in errorStats,
    src/sapling_api.h:342-379). Every rank passes the same errors."""
    errors = np.asarray(errors, dtype=np.int64)
    lo = int(errors.min()) if lo is None else lo
    hi = int(errors.max()) + 1 if hi is None else hi
    width = max(1, (hi - lo + nbins - 1) // nbins)
    padded, b = pad_to_multiple(errors, mesh.shape["dp"], lo)  # bin 0
    e = torch.from_numpy(padded[dp_slice(padded.shape[0], mesh)]).to(
        mesh.device)
    bins = torch.clamp((e - lo) // width, 0, nbins - 1)
    h = all_reduce(torch.bincount(bins, minlength=nbins),
                   mesh.groups["dp"]).cpu().numpy()
    h[0] -= padded.shape[0] - b     # the padding, counted in bin 0
    return h
