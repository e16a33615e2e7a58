"""Models and lane batches for the NN rank-prediction kernel's tests, on the
CPU (tests/test_torch_nn_predict_cu_on_cpu.py, the kernel's source against
a stand-in CUDA runtime) and on the card (tests/test_torch_nn_predict_
cuda.py). Imports neither jax nor sapling_tpu.

GROUPING names the cases that the kernel's grouping of a tile's lanes by
chunk must survive: a batch in one chunk, lanes over every chunk in random
and in sorted order, batches of 1, 31 and a tile plus one lane, one chunk
in all, widths of 1, 5, 16 and 33 units, models past the shared-memory
staging limit (read in place) or past the histogram's bins (neighbouring
chunks share a bin), and for the chunk search's table of cells every
boundary in one cell, and x past x_max.
"""

import numpy as np
import torch

from sapling_tpu_torch.ops import nn_predict_cuda

X_MAX = 4 ** 13 - 1

# name: (chunks, units, lanes (None: a tile and one), x: "random" over
# [0, X_MAX], "past" it (to 2 X_MAX), "every" chunk in random order,
# "sorted", "one" chunk)
GROUPING = {
    "one_chunk": (64, 16, 5000, "one"),
    "every_chunk": (64, 16, 6000, "every"),
    "every_chunk_sorted": (64, 16, 6000, "sorted"),
    "b1": (64, 16, 1, "random"),
    "b31": (64, 16, 31, "random"),
    "tile_plus_1": (64, 16, None, "every"),
    "c1": (1, 16, 3000, "random"),
    "s1": (64, 1, 3000, "every"),
    "s5": (64, 5, 3000, "every"),
    "s16": (64, 16, 3000, "random"),
    "s33": (64, 33, 3000, "every"),
    "global_s41": (300, 41, 5000, "every"),
    "global_binned": (3000, 16, 9000, "every"),
    "shared_binned": (2000, 1, 9000, "every"),
    "clustered": (64, 16, 6000, "every"),
    "past_x_max": (64, 16, 3000, "past"),
}
# boundaries within 2^-12 of 0.5 (a cell of the kernel's search table is
# 2^-8 wide), the first 0
CLUSTERED = ("clustered",)


def random_model(c, s, seed, x_max, scale, n):
    """Random float64 parameters for c chunks of s units, ascending float32
    boundaries below 1 (the first 0, as training's are from the smallest
    k-mer), and un-scaling constants of magnitude `scale`, on the CPU."""
    rng = np.random.default_rng(seed)
    xb = np.sort(rng.integers(0, x_max, c) / x_max).astype(np.float32)
    xb[0] = 0.0
    t = {"w1": rng.normal(0, 2, (c, 1, s)), "b1": rng.normal(0, 1, (c, s)),
         "w2": rng.normal(0, 1, (c, s, 1)), "b2": rng.normal(0, 1, (c, 1))}
    args = (torch.from_numpy(xb),) + tuple(
        torch.from_numpy(t[k]) for k in ("w1", "b1", "w2", "b2"))
    kw = dict(x_max=x_max, line_m=scale * (0.75 + rng.random() / 7),
              line_c=scale * (0.5 + rng.random() / 11),
              res_ptp=scale * (0.001 + rng.random() / 13),
              res_min=-scale * rng.random() / 17, n=n)
    return args, kw


MARGIN = 8


def wide_chunks(edges):
    """The chunks whose x range holds more than the margins."""
    return np.flatnonzero(np.diff(edges) > 4 * MARGIN)


def grouping_x(xb, kind: str, b: int, seed: int, x_max: int = X_MAX):
    """b int64 lanes of `kind` for boundaries xb (numpy float32)."""
    rng = np.random.default_rng(seed)
    if kind in ("random", "past"):
        return rng.integers(0, (2 if kind == "past" else 1) * x_max + 1, b)
    edges = np.append(np.round(np.asarray(xb, np.float64) * x_max), x_max)
    edges = edges.astype(np.int64)
    # inside a chunk by a margin, so that the rounding of x / x_max to
    # float32 keeps x there
    if kind == "one":
        c = int(np.argmax(np.diff(edges)))     # the widest chunk
        return rng.integers(edges[c] + MARGIN, edges[c + 1] - MARGIN, b)
    wide = wide_chunks(edges)
    c = np.concatenate([wide, rng.choice(wide, max(b - len(wide), 0))])
    x = rng.integers(edges[c] + MARGIN, edges[c + 1] - MARGIN)
    x = rng.permutation(x)[:b]
    return np.sort(x) if kind == "sorted" else x


def grouping_case(name: str, scale: float, n: int, seed: int = 0):
    """A GROUPING case on the CPU: ((xb, w1, b1, w2, b2), keywords, x [B]
    int64), its lanes checked to cover what their kind says under the
    plain version's routing."""
    c, s, b, kind = GROUPING[name]
    b = nn_predict_cuda.kernel_tile() + 1 if b is None else b
    args, kw = random_model(c, s, seed=1000 * c + s, x_max=X_MAX,
                            scale=scale, n=n)
    if name in CLUSTERED:
        rng = np.random.default_rng(c)
        xb = np.sort(0.5 + rng.random(c) / 2 ** 12).astype(np.float32)
        xb[0] = 0.0
        args = (torch.from_numpy(xb),) + args[1:]
    xb = args[0].numpy()
    x = grouping_x(xb, kind, b, seed=seed + s)
    got = nn_predict_cuda.nn_route(torch.from_numpy(x), args[0], X_MAX)[2]
    got = got.numpy()
    if kind == "one":
        assert len(np.unique(got)) == 1
    elif kind in ("every", "sorted") and b >= c:
        edges = np.append(np.round(xb.astype(np.float64) * X_MAX), X_MAX)
        wide = wide_chunks(edges.astype(np.int64))
        assert len(wide) > c // 2 and np.isin(wide, got).all()
    return args, kw, torch.from_numpy(x.astype(np.int64))
