"""Serve the residual NN as the query-path predictor (flag-gated).

The reference's NN/ pipeline is offline research: fit.py trains per-chunk
MLPs and test.py reports error percentiles, but the production query
engine never consumes the model (reference: NN/README.md — the learned
index that SHIPS is the PWL table, src/sapling_api.h:384+). This module
goes one step further on that research axis: the trained residual model
(models.residual, the NN/fit.py replication) becomes the rank predictor
of the real query cascade via ops.query_cuda.plquery_cuda's `pred64` seam,
with error bounds measured by the SAME audit semantics the PWL table
uses (index.pwl.error_audit / getError, src/sapling_api.h:309-337).

Correctness argument, identical to the PWL engine's: the audit bounds
(max_over/max_under) are maxima over ALL genome k-mers, so every present
query's true rank lies inside the probed window — found/-1 status is
exact for present queries no matter how well the NN trained. Which
member of a duplicate run is returned follows the predictor's search
order (as it does between different PWL bucket counts). Absent-query
status is predictor-dependent in the reference too.

Training, the audit's predictions and the query run on the index's
device: the card unless the index was made for the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..index.pwl import ErrorAudit, error_stats
from ..index.suffix_array import fwd_runs_from_rank_kmers
from ..ops import pack as packops
from ..ops.nn_predict_cuda import nn_predict_cuda
from ..ops.query_cuda import plquery_cuda
from .residual import Trainer, params_from_numpy, prepare_dataset


@dataclass
class NNServing:
    """Trained per-chunk residual model + everything needed to serve it
    as a rank predictor: chunk x-boundaries, un-scaling constants, and
    the audit-derived error windows. params and xb are tensors on one
    device; to(device) gives the model on another."""

    params: list                 # [{"w", "b"}] float64 [C, ...] tensors
    xb: torch.Tensor             # float32 [C] first scaled-x per chunk
    x_max: float
    res_min: float
    res_ptp: float
    line_m: float
    line_c: float
    n: int
    k: int
    # audit-derived windows (error_stats semantics, like the PWL table)
    most_over: int = 1
    most_under: int = 1
    max_over: int = 2
    max_under: int = 2

    @property
    def device(self) -> torch.device:
        return self.xb.device

    def to(self, device) -> "NNServing":
        """This model on `device`: self when it is there already, else a
        copy whose tensors live there (the windows are shared values)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(
            self, xb=self.xb.to(device),
            params=[{k: v.to(device) for k, v in layer.items()}
                    for layer in self.params])

    def predict_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """[B] int64 adjusted k-mer values -> [B] int64 predicted ranks, on
        the model's device: ops.nn_predict_cuda.nn_predict, whose kernel
        computes them on the card in one launch (the plain torch version on
        the CPU), bit for bit alike."""
        if len(self.params) != 2:
            raise NotImplementedError(
                "serving supports the reference default architecture "
                "(hidden_layers == 1) only")
        return nn_predict_cuda(
            x, self.xb, self.params[0]["w"], self.params[0]["b"],
            self.params[1]["w"], self.params[1]["b"], x_max=self.x_max,
            line_m=self.line_m, line_c=self.line_c, res_ptp=self.res_ptp,
            res_min=self.res_min, n=self.n)


def serving_from_numpy(srv, device="cuda") -> NNServing:
    """A serving model with another package's fields (e.g. a `sapling_tpu`
    NNServing, whose params are numpy or JAX arrays) as an NNServing on
    `device`."""
    return NNServing(
        params=params_from_numpy(srv.params, device),
        xb=torch.tensor(np.asarray(srv.xb, dtype=np.float32), device=device),
        **{f: getattr(srv, f) for f in (
            "x_max", "res_min", "res_ptp", "line_m", "line_c", "n", "k",
            "most_over", "most_under", "max_over", "max_under")})


def train_serving(index, num_chunks: int = 64, layer_size: int = 16,
                  epochs: int = 300, sample_stride: int = 1,
                  seed: int = 0, log=None) -> NNServing:
    """Train the residual family on an index's (k-mer, rank) stream, on the
    index's device, and package it for serving. sample_stride > 1 trains
    on a subsample (the reference's sampleSa stride, NN/sampleSa.cpp:42-74)
    — the audit below still covers every k-mer, so bounds stay exact.
    `log` receives the trainer's lines and, at the end, the epochs run and
    the early-stopped chunks."""
    if index.codes is None or index.inv is None or not len(index.inv):
        raise ValueError("index needs host codes + full inv to train")
    kmers = packops.kmers_scan(index.codes, index.k)
    ranks = np.asarray(index.inv[: kmers.shape[0]], dtype=np.int64)
    ds = prepare_dataset(kmers, ranks, num_chunks,
                         sample_stride=sample_stride)
    c_count = ds.x.shape[0]
    trainer = Trainer.create(seed, c_count, layer_size, device=index.device)
    hist = trainer.fit(ds, epochs=epochs, log=log)
    if log:
        log(f"trained {len(hist)} epochs, "
            f"{int((trainer.stop_epochs >= 0).sum())}/{c_count} chunks "
            "early-stopped")
    # chunk boundary = first scaled x of each chunk (sorted stream)
    xb = np.ascontiguousarray(ds.x[:, 0, 0], dtype=np.float32)
    srv = NNServing(
        params=[{k: v.detach() for k, v in layer.items()}
                for layer in trainer.params],
        xb=torch.from_numpy(xb).to(index.device), x_max=ds.x_max,
        res_min=ds.res_min, res_ptp=ds.res_ptp, line_m=ds.line_m,
        line_c=ds.line_c, n=index.n, k=index.k)
    audit_serving(srv, index, kmers=kmers)
    return srv


def audit_serving(srv: NNServing, index, kmers: np.ndarray | None = None,
                  batch: int = 1 << 22) -> ErrorAudit:
    """Predict EVERY genome k-mer with the serving path (on the model's
    device) and derive the most/max error windows — the exact
    getError/errorStats semantics the PWL audit uses (index.pwl
    error_audit + error_stats, reference src/sapling_api.h:309-379),
    including the bounded under-shot shift along lcp>=k runs. Writes the
    windows into srv and returns the audit."""
    if kmers is None:
        kmers = packops.kmers_scan(index.codes, index.k)
    inv = np.asarray(index.inv[: kmers.shape[0]], dtype=np.int64)
    fwd = fwd_runs_from_rank_kmers(kmers, index.inv, index.n)
    m = kmers.shape[0]
    errors = np.empty(m, dtype=np.int64)
    with torch.no_grad():
        for lo in range(0, m, batch):
            hi = min(lo + batch, m)
            pred = srv.predict_ranks(
                torch.from_numpy(kmers[lo:hi]).to(srv.device)).cpu().numpy()
            y = inv[lo:hi]
            runs = np.where(y < fwd.shape[0],
                            fwd[np.minimum(y, fwd.shape[0] - 1)], 0)
            y_shift = np.where(y < pred, np.minimum(pred, y + runs), y)
            errors[lo:hi] = y_shift - pred
    audit = ErrorAudit(errors=errors,
                       perfect_predictions=int((errors == 0).sum()))
    mo, mu, _me, so, su = error_stats(audit)
    srv.max_over, srv.max_under = mo, mu
    srv.most_over, srv.most_under = so, su
    return audit


class NNQueryEngine:
    """SaplingIndex-shaped query front-end that predicts with the NN
    instead of the PWL table. Same cascade, same probe arrays, the NN's
    own audited windows, on the index's device. Flag-gated research
    engine (the PWL engine remains the default, as in the reference)."""

    def __init__(self, index, serving: NNServing):
        if serving.n != index.n or serving.k != index.k:
            raise ValueError("serving model was trained for a different "
                             f"index (n={serving.n}, k={serving.k})")
        self.idx = index
        self.srv = serving.to(index.device)

    def query_device(self, x: torch.Tensor, q3: torch.Tensor | None,
                     q_words: torch.Tensor | None,
                     stats: bool = False) -> torch.Tensor:
        """plQuery of k-base queries over prepared device inputs
        (SaplingIndex.query_inputs), ranks predicted by the NN -> int64
        [B] positions on the index's device, -1 = not found (on the card
        two launches: the nn_predict kernel, then the plquery kernel
        through its pred64 seam; `stats` as in
        SaplingIndex.query_device)."""
        idx, srv = self.idx, self.srv
        dev = idx.device_arrays()
        with torch.no_grad():
            pred = srv.predict_ranks(x)
        return plquery_cuda(
            dev["packed"], dev["rev"], dev["xlist"], dev["ylist"], q_words,
            x, dev["prefix64"], dev["prefix3"], q3,
            n=idx.n, length=idx.k, k=idx.k, buckets=idx.buckets,
            most_over=srv.most_over, most_under=srv.most_under,
            max_over=srv.max_over, max_under=srv.max_under, pred64=pred,
            stats=stats)

    def query_positions(self, codes2d: np.ndarray) -> np.ndarray:
        length = int(codes2d.shape[1])
        if length != self.idx.k:
            raise NotImplementedError(
                "NN engine serves length == k queries (the model is "
                "trained on the k-mer stream); use the PWL engine for "
                "other lengths")
        return self.query_device(
            *self.idx.query_inputs(codes2d)).cpu().numpy()
