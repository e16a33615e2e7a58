"""The general generator of lookup traffic, driven by a mix's file.

A mix (`portbench/traffic/<name>.json`) is a closed loop of one client
with one request in flight. Its keys:

  * `entry`: the program entry its requests drive (`portbench/entries/
    <entry>.py`);
  * `queries_per_request`: queries in one request, all of one length;
  * `lengths`: the query lengths; every block of len(lengths) requests
    holds each length once, in an order drawn from the seed, so every seed
    sends the same work in another order;
  * `random_share`: the share of a batch's queries that are uniform random
    bases (mostly absent from the genome); the rest are genome substrings
    at uniform random positions; the two are shuffled together;
  * `pool_per_length`: distinct batches made for each length in set-up;
    request i of a length sends that length's batch i mod pool.

Everything is drawn from `--seed` with numpy's generator, so the same seed
gives the same queries on any machine.
"""

from __future__ import annotations

import numpy as np

# keys of a mix file the generator reads
MIX_KEYS = ("entry", "queries_per_request", "lengths", "random_share")


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), *stream]))


def lookup_batch(codes: np.ndarray, length: int, count: int,
                 random_share: float, rng: np.random.Generator) -> np.ndarray:
    """uint8 [count, length] query codes (0..3) from the genome's codes:
    genome substrings at uniform positions and a `random_share` of uniform
    random rows, in a shuffled order."""
    n_random = int(round(count * random_share))
    n_in = count - n_random
    starts = rng.integers(0, codes.shape[0] - length + 1, n_in)
    windows = np.lib.stride_tricks.sliding_window_view(codes, length)
    order = rng.permutation(count)
    out = np.empty((count, length), dtype=np.uint8)
    out[order[:n_in]] = windows[starts]
    out[order[n_in:]] = rng.integers(0, 4, (n_random, length),
                                     dtype=np.uint8)
    return out


class LookupTraffic:
    """A mix's batches and request order for one seed."""

    def __init__(self, mix: dict, seed: int):
        missing = [k for k in MIX_KEYS if k not in mix]
        if missing:
            raise ValueError(f"traffic mix lacks {missing}")
        self.mix = mix
        self.seed = seed
        self.lengths = [int(v) for v in mix["lengths"]]
        self.count = int(mix["queries_per_request"])
        if self.count < 1 or not self.lengths:
            raise ValueError("a mix needs queries and lengths")

    def batch(self, codes: np.ndarray, length: int) -> np.ndarray:
        """The query codes of the batch of this length."""
        rng = _rng(self.seed, 1, length)
        return lookup_batch(codes, length, self.count,
                            float(self.mix["random_share"]), rng)

    def schedule(self):
        """The length of each request, in order, without end."""
        rng = _rng(self.seed, 2)
        while True:
            for i in rng.permutation(len(self.lengths)):
                yield self.lengths[int(i)]
