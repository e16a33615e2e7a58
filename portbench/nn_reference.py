"""The plain reference of the NN engine's rank prediction, in plain
PyTorch: it imports neither JAX nor any module of the program.

From a served model's parameters (any object with the fields of the
program's NNServing: `params` [{"w", "b"}], the 1 -> s -> 1 MLPs stacked
by chunk, w1 [C, 1, s], b1 [C, s], w2 [C, s, 1], b2 [C, 1]; `xb` [C], the
first scaled k-mer of each chunk; `x_max`, `line_m`, `line_c`, `res_ptp`,
`res_min` and `n`) the rank the model predicts for each k-mer, as
mkirsche/sapling's NN/ defines the model:

  * the k-mer scaled to [0, 1] by the largest (NN/preprocess.py:97-131),
    taken as float32, the precision of the training set's inputs;
  * its chunk: the last chunk whose first scaled k-mer is at or below it,
    clamped to the chunks (the sorted stream cut in C pieces,
    NN/fit.py:132-155);
  * the chunk's MLP: relu(x w1 + b1) w2 + b2 (NN/fit.py:185-209);
  * un-scaled to a suffix-array row: the straight line at x less the
    residual (res * ptp + min) (NN/test.py:182-185), rounded to the
    nearest row and clipped to [0, n - 1].

It computes in `dtype`: float64, the configuration's precision, or a
lower one for the comparison's lower reading. Its sums are torch's, in
whatever order the device takes them, so a row that lies on a rounding
edge may round the other way than the program's: it matches the
program's ranks within 1.
"""

from __future__ import annotations

import torch

# k-mers predicted at a time (the gathers take ~40 bytes a unit a k-mer)
BLOCK = 1 << 22


def predict_ranks(model, x: torch.Tensor, dtype=torch.float64,
                  block: int = BLOCK) -> torch.Tensor:
    """int64 [B] predicted ranks of the int64 [B] k-mers x, on x's
    device."""
    dev = x.device
    (w1, b1), (w2, b2) = ((layer["w"].to(dev, dtype),
                           layer["b"].to(dev, dtype))
                          for layer in model.params)
    xb = model.xb.to(dev, torch.float32)
    x_max = torch.tensor(model.x_max, dtype=dtype, device=dev)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=dev)
    for lo in range(0, x.shape[0], block):
        scaled = x[lo:lo + block].to(dtype) / x_max
        xs = scaled.to(torch.float32)
        chunk = torch.clamp(torch.searchsorted(xb, xs, right=True) - 1, 0,
                            xb.shape[0] - 1)
        h = torch.relu(xs.to(dtype)[:, None] * w1[chunk, 0] + b1[chunk])
        res = (h * w2[chunk, :, 0]).sum(dim=1) + b2[chunk, 0]
        rows = (scaled * model.line_m + model.line_c) - (
            res * model.res_ptp + model.res_min)
        out[lo:lo + block] = torch.clamp(torch.round(rows), 0,
                                         model.n - 1).to(torch.int64)
    return out


def rank_gap(model, x: torch.Tensor, pred: torch.Tensor, limit: int = 1,
             dtype=torch.float64) -> tuple[int, int]:
    """(the largest |pred - reference|, the k-mers more than `limit` ranks
    apart) of the ranks `pred` that a program predicted for the k-mers x,
    against this reference in `dtype`."""
    gap = (predict_ranks(model, x, dtype) - pred.to(x.device)).abs()
    return int(gap.max()), int((gap > limit).sum())
