"""Learned residual models on PyTorch: the NN/ research pipeline.

The reference trains ONE PyTorch MLP per suffix-array chunk in a separate
process per chunk (reference: NN/fit.py:185-277 — MLP 1->s->...->1 with
ReLU, Adam, MSE, batch 64, convergence-window early stop), after a NumPy
preprocessing step that scales k-mer values to [0,1] and regresses the
residual against the straight line through the first and last points
(reference: NN/preprocess.py:97-131). Evaluation un-scales predictions
back to suffix-array rows and reports error percentiles
(reference: NN/test.py:171-215).

Here the whole per-chunk family trains at once: the parameters of every
chunk are stacked on a leading [C] axis (StackedMLP), one batched product
per layer runs every chunk's forward, and one Adam step updates every
chunk, each chunk frozen on its own when it converges.

Parameters and activations are float64, as in the JAX package (which
enables x64 at import, so its parameters and its Adam state are float64;
the dataset's float32 x and targets promote to float64 in the forward).
The Adam is optax.adam's, written out in optax's order of operations, so
a fit from the same initial parameters follows the JAX trainer to
rounding.

As in the reference, these models are research artifacts: the production
query path remains the PWL index (index.pwl).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..parallel.mesh import all_gather, all_reduce

F64 = torch.float64


@dataclass
class ResidualDataset:
    """Scaled per-chunk training arrays (numpy, or tensors on the device
    prepare_dataset was given) + the constants to un-scale.

    x:   float32 [C, S, 1]  k-mer values scaled to [0, 1]
    res: float32 [C, S, 1]  residual-vs-line targets scaled to [0, 1]
    valid: bool [C, S]      mask (last chunk may be ragged)
    """

    x: np.ndarray
    res: np.ndarray
    valid: np.ndarray
    res_min: float
    res_ptp: float
    line_m: float
    line_c: float
    x_max: float

    def unscale_to_rows(self, pred_scaled: np.ndarray, x_scaled: np.ndarray):
        """Predicted scaled residual -> predicted suffix-array row
        (reference: NN/test.py:182-185: res = pred*ptp + min; row =
        line(x) - res)."""
        res = pred_scaled * self.res_ptp + self.res_min
        line = x_scaled * self.line_m + self.line_c
        return line - res


def prepare_dataset(kmers, ranks, num_chunks: int,
                    sample_stride: int = 1) -> ResidualDataset:
    """Sort (kmer, rank) pairs by kmer, scale, regress out the straight
    line, and chunk — the preprocess.py pipeline as one vectorized pass.

    kmers/ranks: the (SA rank, kmer value) pairs the reference dumps with
    NN/sampleSa.cpp:42-74 and sorts with `sort -k2,2` (NN/README.md:14),
    as numpy arrays (the dataset's arrays are then numpy) or as int64
    tensors on one device (then tensors there, so that training on the
    card reads no host array). Every step is a torch operation that rounds
    as numpy's does (a stable sort, float64 operations one at a time, the
    divisions by tensors on the data's device: CUDA divides by a Python
    number through its reciprocal), so both give the same bits.
    """
    host = isinstance(kmers, np.ndarray)
    k, r = (torch.from_numpy(np.asarray(a, dtype=np.int64)) if host
            else a.to(torch.int64) for a in (kmers, ranks))
    order = torch.sort(k, stable=True).indices
    xs = k[order][::sample_stride].to(F64)
    ys = r[order][::sample_stride].to(F64)
    del k, r, order
    m_total = xs.shape[0]

    def scalar(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=F64, device=xs.device)

    x_max = float(xs.max()) if m_total else 1.0
    x = xs / scalar(x_max)
    # straight line through first and last points (preprocess.py:104-110)
    dx = float(x[-1] - x[0])
    y0, y1 = float(ys[0]), float(ys[-1])
    m = (y1 - y0) / (dx if dx else 1.0)
    c = y0 - float(x[0]) * m
    true_res = (x * m + c) - ys
    res_min = float(true_res.min())
    res_ptp = (float(true_res.max()) - res_min) or 1.0
    res = (true_res - res_min) / scalar(res_ptp)

    # Exactly num_chunks equal-shaped chunks; the reference gives the ragged
    # tail to the last model (fit.py:139-155), we pad + mask it instead so
    # shapes stay static for one vmapped program.
    c_count = max(1, min(num_chunks, m_total))
    s = (m_total + c_count - 1) // c_count
    pad = c_count * s - m_total

    def _pad(a):
        a = torch.cat([a, a.new_zeros(pad)]).reshape(c_count, s)
        return a.numpy() if host else a

    return ResidualDataset(
        x=_pad(x.to(torch.float32))[..., None],
        res=_pad(res.to(torch.float32))[..., None],
        valid=_pad(torch.ones(m_total, dtype=torch.bool, device=xs.device)),
        res_min=res_min, res_ptp=res_ptp, line_m=float(m), line_c=float(c),
        x_max=x_max,
    )


def init_params(generator: torch.Generator, num_chunks: int,
                layer_size: int, hidden_layers: int = 1,
                device="cuda") -> list[dict[str, torch.Tensor]]:
    """Stacked per-chunk MLP parameters, 1 -> s -> (s ...) -> 1, float64:
    [{"w": [C, din, dout], "b": [C, dout]}, ...].

    PyTorch's default Kaiming-uniform bounds (±1/sqrt(din)), as the
    reference's nn.Linear layers draw them (fit.py:185-209), drawn on the
    host from `generator` so that every device starts from the same
    values. The stream is torch's, not JAX's threefry: to start from the
    JAX package's values, carry them across with params_from_numpy."""
    dims = [1] + [layer_size] * hidden_layers + [1]
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(din)
        w = torch.empty((num_chunks, din, dout), dtype=F64)
        b = torch.empty((num_chunks, dout), dtype=F64)
        params.append({
            "w": w.uniform_(-bound, bound, generator=generator).to(device),
            "b": b.uniform_(-bound, bound, generator=generator).to(device),
        })
    return params


def params_from_numpy(layers, device="cuda") -> list[dict[str, torch.Tensor]]:
    """[{"w", "b"}, ...] of host arrays (the JAX package's parameters, or
    nn_pipeline's model.npz members p{i}_w / p{i}_b) -> float64 tensors on
    `device`."""
    return [{name: torch.tensor(np.asarray(layer[name]), dtype=F64,
                                device=device) for name in ("w", "b")}
            for layer in layers]


def params_to_numpy(params) -> list[dict[str, np.ndarray]]:
    """The inverse of params_from_numpy: host float64 arrays (copies, which
    a later training step leaves as they are)."""
    return [{name: layer[name].detach().to("cpu", copy=True).numpy()
             for name in ("w", "b")}
            for layer in params]


class _SumOverTp(torch.autograd.Function):
    """Forward: the sum over the tp group; backward: the identity. Every tp
    rank computes the same loss from the sum, so each rank's own gradient
    of it is already the whole gradient of its partial product
    (torch.distributed.nn's all_reduce would sum the gradients too, tp
    times too large)."""

    @staticmethod
    def forward(ctx, h, group):
        return all_reduce(h.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOverTp(torch.autograd.Function):
    """Forward: the tp group's hidden units side by side (last axis);
    backward: the sum over the group of the gradients of the gathered
    activations, this rank's units' slice of it. Each rank's next layer
    reads every unit but holds only its own output units, so every rank
    adds a part of each unit's gradient."""

    @staticmethod
    def forward(ctx, h, group):
        ctx.group = group
        ctx.width = h.shape[-1]
        ctx.me = dist.get_rank(group)
        parts = all_gather(h.movedim(-1, 0), group)
        return parts.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous(), ctx.group)
        lo = ctx.me * ctx.width
        return g[..., lo:lo + ctx.width], None


def forward(params, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Every chunk's MLP at once: x [C, B, 1] -> [C, B, 1] float64. x is
    cast to float64 first (exact from float32), as JAX promotes it.

    tp: the process group over which shard_for_mesh split the hidden units
    (each hidden layer's output units, the last layer's input rows), or
    None. Hidden activations are gathered over it before a hidden layer,
    and the last layer's partial products summed over it before its
    bias."""
    h = x.to(F64)
    last = len(params) - 1
    for i, layer in enumerate(params):
        if tp is not None and 0 < i < last:
            h = _GatherOverTp.apply(h, tp)
        h = torch.einsum("cbi,cio->cbo", h, layer["w"])
        if tp is not None and i == last:
            h = _SumOverTp.apply(h, tp)
        h = h + layer["b"][:, None, :]
        if i < last:
            h = torch.relu(h)
    return h


def _squared_errors(params, x, y, valid, tp=None):
    pred = forward(params, x, tp)
    return ((pred - y) ** 2).squeeze(-1) * valid


def mse_loss(params, x, y, valid, tp=None, dp=None):
    """The mean squared error over every valid point of every chunk.

    tp: forward's hidden-unit group. dp: the group over which
    shard_for_mesh split the chunks, or None; the local squared errors are
    then divided by the valid count of every chunk (summed over dp), so
    the gradient of each rank's loss is that of the global mean for its
    own chunks, and the global mean is the sum of the dp ranks' losses."""
    se = _squared_errors(params, x, y, valid, tp)
    count = valid.sum()
    if dp is not None:
        count = all_reduce(count.clone(), dp)
    return se.sum() / torch.clamp(count, min=1)


def mse_loss_per_chunk(params, x, y, valid):
    """Per-chunk MSE [C] — each chunk normalized by its own valid count,
    exactly the loss each of the reference's independent per-chunk
    training processes sees (fit.py:211,238)."""
    se = _squared_errors(params, x, y, valid)
    return se.sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1)


class StackedMLP(nn.Module):
    """The per-chunk MLP family as one module: layer i holds parameters
    w{i} [C, din, dout] and b{i} [C, dout], float64."""

    def __init__(self, params):
        super().__init__()
        self.depth = len(params)
        for i, layer in enumerate(params):
            self.register_parameter(f"w{i}", nn.Parameter(layer["w"].clone()))
            self.register_parameter(f"b{i}", nn.Parameter(layer["b"].clone()))

    @property
    def params(self) -> list[dict[str, torch.Tensor]]:
        """The parameters as [{"w", "b"}, ...] (the module's own tensors)."""
        return [{"w": getattr(self, f"w{i}"), "b": getattr(self, f"b{i}")}
                for i in range(self.depth)]

    def forward(self, x):
        return forward(self.params, x)


@dataclass
class AdamState:
    """optax.adam's state: one step count for every chunk, and the first
    and second moments of each parameter (in StackedMLP.parameters()
    order)."""

    count: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


def _adam(params, grads, state: AdamState, lr: float, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8):
    """One optax.adam(lr) step (eps_root 0) in optax's order of operations:
    the moments, the bias corrections of the incremented count, then
    p + (-lr) * mu_hat / (sqrt(nu_hat) + eps). Returns (new params, new
    state); nothing is updated in place."""
    count = state.count + 1
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
    new = [p + (-lr) * ((m / c1) / (torch.sqrt(v / c2) + eps))
           for p, m, v in zip(params, mu, nu)]
    return new, AdamState(count=count, mu=mu, nu=nu)


def _chunk_mask(active: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return active.reshape((-1,) + (1,) * (like.ndim - 1))


@dataclass
class Trainer:
    """All-chunks-at-once trainer with the reference's convergence rule,
    on the device its model lives on."""

    model: StackedMLP
    opt_state: AdamState
    lr: float = 1e-3

    @classmethod
    def create(cls, seed_or_generator, num_chunks: int, layer_size: int,
               hidden_layers: int = 1, lr: float = 1e-3, device="cuda"):
        """A trainer with init_params drawn from a seed (an int) or a
        torch.Generator, on `device`."""
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator().manual_seed(int(gen))
        return cls.from_params(
            init_params(gen, num_chunks, layer_size, hidden_layers,
                        device=device), lr=lr)

    @classmethod
    def from_params(cls, params, lr: float = 1e-3):
        """A trainer starting from given parameters (e.g. carried across
        with params_from_numpy), with a fresh Adam state (fit.py:214 uses
        Adam's defaults)."""
        model = StackedMLP(params)
        zeros = [torch.zeros_like(p) for p in model.parameters()]
        return cls(model=model, lr=lr, opt_state=AdamState(
            count=0, mu=zeros, nu=[z.clone() for z in zeros]))

    @property
    def params(self) -> list[dict[str, torch.Tensor]]:
        return self.model.params

    @property
    def device(self) -> torch.device:
        return self.model.w0.device

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _grads(self, loss_fn, x, y, valid, **groups):
        """(loss, grads) of loss_fn(params, x, y, valid, **groups) summed
        over its entries, for every parameter of the model."""
        params = list(self.model.parameters())
        loss = loss_fn(self.model.params, x, y, valid, **groups)
        grads = torch.autograd.grad(loss.sum(), params)
        return loss.detach(), params, grads

    def train_step(self, x, y, valid, tp=None, dp=None) -> torch.Tensor:
        """One plain Adam step on the mean loss over all chunks (no
        per-chunk freezing), in place; returns the loss before the step.
        x, y: [C, B, 1]; valid: [C, B] (host arrays or tensors). After
        shard_for_mesh: this rank's slices and the mesh's groups (tp, dp);
        the returned loss is then the global mean, summed over dp, and
        Adam stays elementwise on the local shards."""
        x, y = self._tensor(x), self._tensor(y)
        valid = self._tensor(valid, torch.float32)
        loss, params, grads = self._grads(mse_loss, x, y, valid, tp=tp,
                                          dp=dp)
        if dp is not None:
            loss = all_reduce(loss.clone(), dp)
        new, self.opt_state = _adam(params, grads, self.opt_state, self.lr)
        with torch.no_grad():
            for p, q in zip(params, new):
                p.copy_(q)
        return loss

    def _masked_step(self, x, y, valid, active, best_loss, best):
        """One training step over all chunks with PER-CHUNK freezing:
        `active` [C] gates both the parameter update and the moments, so a
        converged chunk's training stops exactly as the reference's
        independent per-chunk process would (fit.py:259-277 breaks out of
        that chunk's loop); the step count advances for all. A chunk whose
        loss (before the update) improved records the parameters after the
        update as its best, as the JAX trainer does (fit.py:252-258).
        Updates the model, the state, best_loss and best in place; returns
        the per-chunk losses."""
        lv, params, grads = self._grads(mse_loss_per_chunk, x, y, valid)
        new, st = _adam(params, grads, self.opt_state, self.lr)
        old = self.opt_state
        with torch.no_grad():
            for i, p in enumerate(params):
                a = _chunk_mask(active, p)
                p.copy_(torch.where(a, new[i], p))
                st.mu[i] = torch.where(a, st.mu[i], old.mu[i])
                st.nu[i] = torch.where(a, st.nu[i], old.nu[i])
            improved = active & (lv < best_loss)
            best_loss.copy_(torch.where(improved, lv, best_loss))
            for p, bp in zip(params, best):
                bp.copy_(torch.where(_chunk_mask(improved, p), p, bp))
        self.opt_state = st
        return lv

    def fit(self, ds: ResidualDataset, epochs: int = 500,
            convergence_window: int = 50, convergence_threshold: float = 0.1,
            batch: int | None = None, seed: int = 0, log=None):
        """Training loop with the reference's early stop applied PER
        CHUNK: chunk c stops when the best loss in ITS trailing window
        improves on ITS prior best by less than threshold*prior
        (fit.py:259-277 — each chunk is an independent process there).
        Minibatch indices are likewise drawn per chunk
        (rng key [seed, epoch, c]; the reference's DataLoader shuffles
        per process, fit.py:180-183), on the host.

        The dataset goes to the device once; the per-chunk losses come back
        once an epoch, for the stop rule. At the end the model holds each
        chunk's best parameters.

        Returns the loss history [epochs_run, C]; per-chunk stop epochs
        land in self.stop_epochs (-1 = ran the full budget)."""
        x, y = self._tensor(ds.x), self._tensor(ds.res)
        valid = self._tensor(ds.valid, torch.float32)
        c_count, s = ds.x.shape[0], ds.x.shape[1]
        bs = min(batch, s) if batch else s
        best_loss = torch.full((c_count,), np.inf, dtype=F64,
                               device=self.device)
        best = [p.detach().clone() for p in self.model.parameters()]
        active_np = np.ones(c_count, dtype=bool)
        self.stop_epochs = np.full(c_count, -1, dtype=np.int64)
        hist = np.empty((epochs, c_count), dtype=np.float64)
        n_done = 0
        for epoch in range(epochs):
            if bs < s:
                sel = self._tensor(np.stack([
                    np.random.default_rng([seed, epoch, ci])
                    .choice(s, size=bs, replace=False)
                    for ci in range(c_count)]))
                xb = torch.gather(x, 1, sel[:, :, None])
                yb = torch.gather(y, 1, sel[:, :, None])
                vb = torch.gather(valid, 1, sel)
            else:
                xb, yb, vb = x, y, valid
            lv = self._masked_step(xb, yb, vb, self._tensor(active_np),
                                   best_loss, best)
            hist[epoch] = lv.cpu().numpy()
            n_done = epoch + 1
            if log and epoch % 50 == 0:
                log(f"epoch {epoch} mean loss {hist[epoch].mean():.6f} "
                    f"({int(active_np.sum())}/{c_count} chunks active)")
            if epoch > convergence_window:
                # reference slices exclude the current epoch's entry
                # (fit.py:262-264: loss_list[:epoch-w], [epoch-w:epoch])
                prior = hist[: epoch - convergence_window].min(axis=0)
                window = hist[epoch - convergence_window : epoch].min(axis=0)
                stop = active_np & (prior - window
                                    < convergence_threshold * prior)
                self.stop_epochs[stop] = epoch
                active_np &= ~stop
                if not active_np.any():
                    break
        with torch.no_grad():
            for p, bp in zip(self.model.parameters(), best):
                p.copy_(bp)
        return hist[:n_done]

    def predict_rows(self, ds: ResidualDataset) -> np.ndarray:
        """Predict suffix-array rows for the whole dataset
        (test.py:171-188)."""
        with torch.no_grad():
            pred = self.model(self._tensor(ds.x)).cpu().numpy()
        rows = ds.unscale_to_rows(pred[..., 0], ds.x[..., 0])
        return rows[ds.valid]


def error_percentiles(pred_rows: np.ndarray, true_rows: np.ndarray,
                      pcts=(50, 75, 90, 95, 99, 100)) -> dict[str, float]:
    """Error metrics in suffix-array rows (reference: NN/test.py:191-215)."""
    err = np.abs(pred_rows - true_rows)
    out = {"mean": float(err.mean())}
    for p in pcts:
        out[f"p{p}"] = float(np.percentile(err, p))
    return out


def shard_for_mesh(trainer: Trainer, ds: ResidualDataset, mesh):
    """This rank's part of SPMD training over a ("dp", "tp") mesh
    (parallel.mesh): the chunk axis over "dp", the hidden units over "tp"
    (every hidden layer's output units and bias, the last layer's input
    rows; the last bias whole), as JAX's shard_for_mesh places them. The
    trainer keeps only its shard of the parameters, with a fresh Adam
    state; returns this rank's (x, y, valid) slices of the dataset. Then
    trainer.train_step(x, y, valid, tp=mesh.groups["tp"],
    dp=mesh.groups["dp"]) takes one step of the whole family."""
    ndp, ntp = mesh.shape["dp"], mesh.shape["tp"]
    d, t = mesh.coords["dp"], mesh.coords["tp"]
    c = ds.x.shape[0]
    if c % ndp:
        raise ValueError(f"dp={ndp} must divide the {c} chunks")
    chunks = slice(d * c // ndp, (d + 1) * c // ndp)

    def units(n):
        if n % ntp:
            raise ValueError(f"tp={ntp} must divide {n} hidden units")
        return slice(t * n // ntp, (t + 1) * n // ntp)

    params = trainer.params
    last = len(params) - 1
    local = []
    with torch.no_grad():
        for i, layer in enumerate(params):
            w, b = layer["w"][chunks], layer["b"][chunks]
            if i < last:
                cols = units(w.shape[2])
                w, b = w[:, :, cols], b[:, cols]
            else:
                w = w[:, units(w.shape[1]), :]
            local.append({"w": w.contiguous(), "b": b.contiguous()})
    fresh = Trainer.from_params(local, lr=trainer.lr)
    trainer.model, trainer.opt_state = fresh.model, fresh.opt_state
    return (trainer._tensor(ds.x[chunks]), trainer._tensor(ds.res[chunks]),
            trainer._tensor(ds.valid[chunks], torch.float32))
