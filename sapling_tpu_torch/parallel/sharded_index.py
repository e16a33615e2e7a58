"""Index-sharded query execution: genomes bigger than one card's memory.

The data-parallel engine (parallel.query) holds the whole index on every
rank. The reference's largest published benchmark genome is wheat at
14.3 Gbp (reference: eval/TimingPlot/plot.py:16), whose rank array alone
takes 71.5 GB at 5 bytes a rank: most of an 80 GB H100 before anything
else. Here the big per-RANK arrays (rev, and the probe prefixes where
they exist) are split by contiguous suffix-array rank ranges over a mesh
axis "idx", the small packed genome and PWL table are on every rank, and
each probe's local masked gather is combined with one all_reduce over the
rank's "idx" group (ops.query.make_take).

Probes for ranks owned elsewhere gather local index 0 and contribute 0,
so the decision sequence is the single-device engine's and the results
are bit-identical to it (and hence to the reference); the added cost is
one [B]-lane all_reduce a gather.

Composes with data parallelism on a 2-D ("dp", "idx") mesh: query lanes
shard over "dp", every dp row holds one full copy of the index spread
over its "idx" columns.

Device memory a rank, wheat (14.3 Gbp) on 8 ranks of 80 GB H100s, in
bytes:
  rev as SplitRanks (uint32 lo + uint8 hi = 5 B/rank), sharded
      14.3e9 * 5 / 8                                      =  8.94e9
  packed genome, int64 words (the port widens the 2-bit
      words to 8 bytes: 14.3e9 / 16 * 8)                  =  7.15e9
  PWL table 2^26 buckets, int64 xlist + ylist
      2 * 2^26 * 8                                        =  1.07e9
  total a rank                                            ~ 17.2e9
which leaves room for the query's [B]-lane state on each card
(per-rank prefix arrays are the first thing to drop at this scale;
SaplingIndex.build already gates them on cfg.prefix_max_n).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import pack as packops
from ..ops.query import SplitRanks, binsearch_batch, make_take, plquery_batch
from .mesh import Mesh
from .query import gather_lanes, pack_lanes


class IndexShardedEngine:
    """Rank-sharded query engine over a ("dp", "idx") mesh.

    Same query surface as SaplingIndex / ShardedQueryEngine; the per-rank
    arrays live sharded by contiguous rank range over `idx_axis` on
    index.device, query batches shard over `dp_axis`, and every probe
    combines with an all_reduce over the index axis (ops.query.make_take).
    rev_storage:
      "flat"  — keep the index's storage dtype (uint32 up to 4.3 Gbp, as
                an int32 view);
      "split" — 5 B/rank SplitRanks for 40-bit positions (>= 4.3 Gbp);
      "auto"  — flat when positions fit uint32, else split.
    A split-limb (v4) artifact's limbs are sharded as they are stored.
    """

    def __init__(self, index, mesh: Mesh, *, idx_axis: str = "idx",
                 dp_axis: str = "dp", rev_storage: str = "auto",
                 use_prefix: bool = True):
        self.index = index
        self.mesh = mesh
        self.idx_axis = idx_axis
        self.dp_axis = dp_axis
        n = index.n
        self.shard_size = -(-n // mesh.shape[idx_axis])
        lo = mesh.coords[idx_axis] * self.shard_size
        self._span = (lo, lo + self.shard_size)

        rev = index.rev
        if rev_storage == "auto":
            rev_storage = ("split" if n > np.iinfo(np.uint32).max - 1
                           else "flat")
        if index.rev_hi is not None:
            # v4 split-limb index: the limbs are stored apart already —
            # shard them directly, no 8-byte int64 temporary
            self.rev = SplitRanks(lo=self._shard(rev, np.int32),
                                  hi=self._shard(index.rev_hi))
        elif rev_storage == "split":
            rev64 = self._local(rev).astype(np.int64)
            self.rev = SplitRanks(
                lo=index._put((rev64 & 0xFFFFFFFF).astype(np.uint32)
                             .view(np.int32)),
                hi=index._put((rev64 >> 32).astype(np.uint8)))
        elif rev_storage == "flat":
            self.rev = self._shard(rev, None if rev.dtype == np.int64
                                   else np.int32)
        else:
            raise ValueError(f"rev_storage={rev_storage!r}")
        self.prefix = (self._shard(index.prefix64, np.int64)
                       if use_prefix and index.prefix64 is not None
                       else None)
        self.prefix3 = (self._shard(index.prefix3, np.int64)
                        if use_prefix and index.prefix3 is not None
                        else None)
        t = index.table
        self.packed = index._put(index.packed.astype(np.int64))
        self.xlist = index._put(t.xlist.astype(np.int64))
        self.ylist = index._put(t.ylist.astype(np.int64))
        # per-BUCKET bounds are small -> on every rank; probes stay local
        self.bounds = (index._put(t.bounds.view(np.int32))
                       if t.bounds is not None else None)
        self._take = make_take((mesh.groups[idx_axis], self.shard_size))

    # --- internals ----------------------------------------------------------

    def _local(self, a: np.ndarray) -> np.ndarray:
        """This rank's rank range of a per-rank host array, zero-padded to
        shard_size (padding ranks are never probed: every probed rank is
        < n)."""
        lo, hi = self._span
        out = np.zeros(self.shard_size, dtype=a.dtype)
        part = a[lo:min(hi, a.shape[0])]
        out[:part.shape[0]] = part
        return out

    def _shard(self, a: np.ndarray, view=None) -> torch.Tensor:
        local = self._local(a)
        return self.index._put(local if view is None else local.view(view))

    # --- queries ------------------------------------------------------------

    def query_inputs(self, codes2d: np.ndarray):
        """(x, q3, q_words, B): this rank's lanes of a [B, L] batch on
        index.device (parallel.query.pack_lanes)."""
        length = int(codes2d.shape[1])
        use3 = (self.prefix3 is not None
                and length <= min(self.index.k, packops.P3_BASES))
        return pack_lanes(self.index, codes2d, self.mesh, use3,
                          self.dp_axis)

    def query_device(self, x, q3, q_words, length: int,
                     max_stride_steps: int = 1 << 20,
                     adaptive_bounds: bool = False) -> torch.Tensor:
        """This rank's lanes' positions (int64, on index.device) over
        prepared inputs; every rank of its idx group calls it on the same
        lanes (one all_reduce a per-rank gather)."""
        idx = self.index
        t = idx.table
        return plquery_batch(
            self.packed, self.rev, self.xlist, self.ylist, q_words, x,
            self.prefix, self.prefix3, q3, self.bounds, n=idx.n,
            length=length, k=idx.k, buckets=idx.buckets,
            most_over=t.most_over, most_under=t.most_under,
            max_over=t.max_over, max_under=t.max_under,
            max_stride_steps=max_stride_steps,
            adaptive_bounds=adaptive_bounds, take=self._take)

    def query_positions(self, codes2d: np.ndarray,
                        max_stride_steps: int = 1 << 20,
                        adaptive_bounds: bool = False) -> np.ndarray:
        """[B, L] base codes -> [B] genome positions on every rank;
        bit-identical to SaplingIndex.query_positions (same decision
        sequence, distributed gathers). adaptive_bounds: see
        ops.query.plquery_batch (flagged search-order variant)."""
        x, q3, q_words, b = self.query_inputs(codes2d)
        pos = self.query_device(x, q3, q_words, int(codes2d.shape[1]),
                                max_stride_steps, adaptive_bounds)
        return gather_lanes(pos, self.mesh, b, self.dp_axis)

    def query_positions_binsearch(self, codes2d: np.ndarray) -> np.ndarray:
        """The classic binary-search baseline over the sharded rev."""
        _x, _q3, q_words, b = pack_lanes(self.index, codes2d, self.mesh,
                                         False, self.dp_axis)
        pos = binsearch_batch(self.packed, self.rev, q_words, n=self.index.n,
                              length=int(codes2d.shape[1]), take=self._take)
        return gather_lanes(pos, self.mesh, b, self.dp_axis)
