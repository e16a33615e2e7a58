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
import operator
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..index.pwl import ErrorAudit, error_stats
from ..ops.nn_predict_cuda import NNPredictPlan, nn_predict_cuda
from ..ops.query_cuda import PlqueryPlan, plquery_cuda
from .residual import Trainer, params_from_numpy, prepare_dataset

# the scalar fields of an NNServing, as save_serving writes them
_SCALARS = ("x_max", "res_min", "res_ptp", "line_m", "line_c", "n", "k",
            "most_over", "most_under", "max_over", "max_under",
            "epochs_run", "early_stopped")


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
    # the training that made it: epochs run, chunks stopped early
    epochs_run: int = 0
    early_stopped: int = 0
    # the serving plan of the model's arrays on the card (plan())
    _plan: object = field(default=None, init=False, repr=False,
                          compare=False)

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

    def _arrays(self):
        if len(self.params) != 2:
            raise NotImplementedError(
                "serving supports the reference default architecture "
                "(hidden_layers == 1) only")
        return (self.xb, self.params[0]["w"], self.params[0]["b"],
                self.params[1]["w"], self.params[1]["b"])

    def _consts(self) -> dict:
        return dict(x_max=self.x_max, line_m=self.line_m,
                    line_c=self.line_c, res_ptp=self.res_ptp,
                    res_min=self.res_min, n=self.n)

    def plan(self) -> NNPredictPlan:
        """The model's serving plan on the card (ops.nn_predict_cuda.
        NNPredictPlan: its arrays checked once), made on the first call and
        made anew where the arrays are other tensors."""
        arrays = self._arrays()
        p = self._plan
        if p is None or any(map(operator.is_not, p.arrays, arrays)):
            p = self._plan = NNPredictPlan(*arrays, **self._consts())
        return p

    def predict_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """[B] int64 adjusted k-mer values -> [B] int64 predicted ranks, on
        the model's device: nn_predict_kernel on the card, launched from
        the model's plan (plan()), the plain torch version
        (ops.nn_predict_cuda.nn_predict) on the CPU, bit for bit alike."""
        if x.device.type == "cuda":
            return self.plan()(x)
        return nn_predict_cuda(x, *self._arrays(), **self._consts())


def save_serving(srv: NNServing, path: str) -> None:
    """Write a serving model to `path` (.npz): the parameters as
    nn_pipeline's model.npz names them (p{i}_w, p{i}_b), the boundaries,
    the constants and windows, the training's counts; whole, then renamed
    into place. load_serving reads it back bit for bit."""
    arrays = {f"p{i}_{name}": layer[name].detach().cpu().numpy()
              for i, layer in enumerate(srv.params) for name in ("w", "b")}
    arrays["xb"] = srv.xb.cpu().numpy()
    for name in _SCALARS:
        arrays[name] = np.asarray(getattr(srv, name))
    tmp = f"{path}.partial.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_serving(path: str, device="cuda") -> NNServing:
    """The serving model save_serving wrote to `path`, on `device`."""
    with np.load(path) as z:
        depth = sum(1 for name in z.files if name.endswith("_w"))
        params = params_from_numpy(
            [{name: z[f"p{i}_{name}"] for name in ("w", "b")}
             for i in range(depth)], device)
        return NNServing(
            params=params, xb=torch.from_numpy(z["xb"]).to(device),
            **{name: z[name].item() for name in _SCALARS})


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


def kmer_stream(index):
    """The index's (k-mer, rank) stream and its lcp >= k runs, on the
    index's device, from what a query-time index holds: rev and the packed
    genome (no host codes, inv or LCP). Returns (kmers, ranks, fwd):

      * kmers: int64 [m], m = n - k + 1, the k-mer at each position, 2
        bits a base, the first the most significant (ops.pack.kmers_scan);
      * ranks: int64 [m], the rank of each position (inv[:m]);
      * fwd: int32 [n - 1], the forward runs of lcp >= k between adjacent
        ranks (index.suffix_array.fwd_runs_from_rank_kmers): rank order is
        k-mer order, and ranks r and r + 1 are in one run where their
        k-mers are equal; a suffix shorter than k takes a distinct negative
        sentinel, -1 - (its position - m), so it is in none.
    """
    n, k = index.n, index.k
    m = n - k + 1
    if m < 1:
        raise ValueError(f"a genome of {n} bases has no {k}-mer")
    dev = index.device_arrays()
    rev = dev["rev"][:n].to(torch.int64)
    if dev["rev"].dtype == torch.int32:
        rev &= 0xFFFFFFFF            # uint32 bits
    d = rev.device
    shifts = 30 - 2 * torch.arange(16, device=d)
    codes = ((dev["packed"][:-(-n // 16), None] >> shifts) & 3).reshape(
        -1)[:n]
    kmers = torch.zeros(m, dtype=torch.int64, device=d)
    for j in range(k):
        kmers = (kmers << 2) | codes[j:j + m]
    del codes
    inv = torch.empty(n, dtype=torch.int64, device=d)
    inv[rev] = torch.arange(n, device=d)
    ranks = inv[:m].clone()
    del inv
    by_rank = torch.where(rev < m, kmers[rev.clamp(max=m - 1)],
                          (m - 1) - rev)
    ok = by_rank[:-1] == by_rank[1:]
    del by_rank, rev
    # a run's length: the next break at or after i, less i
    idx = torch.arange(ok.shape[0], device=d)
    breaks = torch.where(ok, ok.shape[0], idx)
    nxt = torch.cummin(breaks.flip(0), 0).values.flip(0)
    fwd = (nxt - idx).clamp(max=torch.iinfo(torch.int32).max).to(torch.int32)
    return kmers, ranks, fwd


def train_serving(index, num_chunks: int = 64, layer_size: int = 16,
                  epochs: int = 300, sample_stride: int = 1,
                  seed: int = 0, log=None) -> NNServing:
    """Train the residual family on an index's (k-mer, rank) stream, on the
    index's device, and package it for serving. The stream and the audit's
    runs come from rev and the packed genome (kmer_stream), so a
    query-time index (loaded without inv and codes) trains as the whole
    one does. sample_stride > 1 trains on a subsample (the reference's
    sampleSa stride, NN/sampleSa.cpp:42-74) — the audit below still covers
    every k-mer, so bounds stay exact. The convergence rule is the
    reference's (Trainer.fit's defaults). `log` receives the trainer's
    lines and, at the end, the epochs run and the early-stopped chunks."""
    stream = kmer_stream(index)
    ds = prepare_dataset(*stream[:2], num_chunks, sample_stride=sample_stride)
    c_count = ds.x.shape[0]
    trainer = Trainer.create(seed, c_count, layer_size, device=index.device)
    hist = trainer.fit(ds, epochs=epochs, log=log)
    stopped = int((trainer.stop_epochs >= 0).sum())
    if log:
        log(f"trained {len(hist)} epochs, {stopped}/{c_count} chunks "
            "early-stopped")
    # chunk boundary = first scaled x of each chunk (sorted stream)
    xb = ds.x[:, 0, 0].contiguous()
    srv = NNServing(
        params=[{k: v.detach() for k, v in layer.items()}
                for layer in trainer.params],
        xb=xb, x_max=ds.x_max, res_min=ds.res_min, res_ptp=ds.res_ptp,
        line_m=ds.line_m, line_c=ds.line_c, n=index.n, k=index.k,
        epochs_run=len(hist), early_stopped=stopped)
    del ds, trainer
    audit_serving(srv, index, stream=stream)
    return srv


def audit_serving(srv: NNServing, index, stream=None,
                  batch: int = 1 << 22) -> ErrorAudit:
    """Predict EVERY genome k-mer with the serving path (on the model's
    device) and derive the most/max error windows — the exact
    getError/errorStats semantics the PWL audit uses (index.pwl
    error_audit + error_stats, reference src/sapling_api.h:309-379),
    including the bounded under-shot shift along lcp>=k runs. `stream`:
    the index's kmer_stream, made here when not given. Writes the windows
    into srv and returns the audit (its errors by position, on the
    host)."""
    kmers, ranks, fwd = (t.to(srv.device) for t in (
        stream if stream is not None else kmer_stream(index)))
    m, runs_len = kmers.shape[0], fwd.shape[0]
    errors = torch.empty(m, dtype=torch.int64, device=srv.device)
    with torch.no_grad():
        for lo in range(0, m, batch):
            hi = min(lo + batch, m)
            pred = srv.predict_ranks(kmers[lo:hi])
            y = ranks[lo:hi]
            runs = torch.where(y < runs_len,
                               fwd[y.clamp(max=runs_len - 1)].to(torch.int64),
                               0)
            y_shift = torch.where(y < pred, torch.minimum(pred, y + runs), y)
            errors[lo:hi] = y_shift - pred
    errors = errors.cpu().numpy()
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
    engine (the PWL engine remains the default, as in the reference).

    On the card a call without stats makes two short launches from plans
    made before its first request: nn_predict_kernel from the model's
    serving plan (NNServing.plan) and plquery_kernel from a launch plan of
    the index's arrays without bucket records, which takes the predictions
    as pred64 (ops.query_cuda.PlqueryPlan), kept with the index's own
    plans (plan()). `counts` holds the plans this engine made and the
    requests they launched."""

    def __init__(self, index, serving: NNServing):
        if serving.n != index.n or serving.k != index.k:
            raise ValueError("serving model was trained for a different "
                             f"index (n={serving.n}, k={serving.k})")
        self.idx = index
        self.srv = serving.to(index.device)
        self.counts = {"plans": 0, "served": 0}

    def query_inputs(self, codes2d: np.ndarray):
        """SaplingIndex.query_inputs with the fast3 probe's q3 where the
        index has prefix3, on the card too: under the NN's wide windows (17
        bisection rounds against PWL's 7 at 4.6 Mbp) one prefix3 load a
        probe ran 1.48x faster on an H100 than rev and the genome."""
        return self.idx.query_inputs(codes2d, fast3=True)

    def _query_kw(self) -> dict:
        """plquery_cuda's (and PlqueryPlan's) keywords of the index and the
        NN's windows, but the length and stats."""
        idx, srv = self.idx, self.srv
        sample, shift = idx.rank_sample(srv.most_over, srv.most_under)
        return dict(n=idx.n, k=idx.k, buckets=idx.buckets,
                    most_over=srv.most_over, most_under=srv.most_under,
                    max_over=srv.max_over, max_under=srv.max_under,
                    rank_recs=idx.query_records()[1], rank_sample=sample,
                    sample_shift=shift)

    def plan(self) -> PlqueryPlan:
        """The engine's launch plan on the card: the index's arrays, rank
        records and their sample, no bucket records (the NN predicts), the
        NN's windows (wide enough, the sampled instance: the plan's
        `sampled`). It is kept with the index's own plans, under ("nn", the
        windows), so that it is made on the first call and dropped, as
        theirs are, where the index makes its records anew
        (SaplingIndex.query_records)."""
        kw = self._query_kw()
        key = ("nn", kw["most_over"], kw["most_under"], kw["max_over"],
               kw["max_under"])
        plans = self.idx._records["plans"]
        p = plans.get(key)
        if p is None:
            dev = self.idx.device_arrays()
            p = plans[key] = PlqueryPlan(
                dev["packed"], dev["rev"], dev["xlist"], dev["ylist"],
                dev["prefix3"], None, bucket_recs=None, **kw)
            self.counts["plans"] += 1
        return p

    def query_device(self, x: torch.Tensor, q3: torch.Tensor | None,
                     q_words: torch.Tensor | None,
                     stats: bool = False) -> torch.Tensor:
        """plQuery of k-base queries over prepared device inputs
        (query_inputs), ranks predicted by the NN -> int64
        [B] positions on the index's device, -1 = not found (on the card
        two launches: the nn_predict kernel, then the plquery kernel
        through its pred64 seam, from the plans without stats; `stats` as
        in SaplingIndex.query_device; the index's rank records, no bucket
        records: the NN predicts)."""
        idx, srv = self.idx, self.srv
        with torch.no_grad():
            pred = srv.predict_ranks(x)
        if x.device.type == "cuda" and not stats:
            out = self.plan()(x, q_words, q3, idx.k, pred64=pred)
            self.counts["served"] += 1
            return out
        dev = idx.device_arrays()
        return plquery_cuda(
            dev["packed"], dev["rev"], dev["xlist"], dev["ylist"], q_words,
            x, dev["prefix64"], dev["prefix3"], q3, length=idx.k,
            pred64=pred, stats=stats, **self._query_kw())

    def query_positions(self, codes2d: np.ndarray) -> np.ndarray:
        length = int(codes2d.shape[1])
        if length != self.idx.k:
            raise NotImplementedError(
                "NN engine serves length == k queries (the model is "
                "trained on the k-mer stream); use the PWL engine for "
                "other lengths")
        return self.query_device(*self.query_inputs(codes2d)).cpu().numpy()
