"""The NN engine's model in the benchmark: its spec, and the model trained
once a checkout and kept beside the index artifact.

`SPEC` is the configuration's `model` object (the entry gets only the
index, so it holds the spec as constants; a test holds them equal to the
file). The first run in a checkout trains the model on the card from the
query-time index the harness loads (`sapling_tpu_torch.models.serve.
train_serving`: rev and the packed genome, no host codes or inv) and saves
it under the benchmark's cache (`.cache/nn/`, `save_serving`); later runs,
and the counted slice's index loaded anew, load it (`load_serving`). Its
key is a digest of the genome's packed words, the index's rules and the
spec, so that another configuration never reuses it. The model is the
program's own, written and read by the program; the benchmark only keeps
it.

`SERVED` records the model the last `served_model` call served (how it
came: "trained" or "loaded", its windows, the epochs run, the chunks
stopped early), read by the `nn_window_ranks` metric.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import sys
import time

import numpy as np
from sapling_tpu_torch.models.residual import Trainer
from sapling_tpu_torch.models.serve import (load_serving, save_serving,
                                            train_serving)

SPEC = {"chunks": 64, "units": 16, "hidden_layers": 1, "epochs": 300,
        "convergence_window": 50, "convergence_threshold": 0.1, "seed": 0,
        "precision": "float64"}
WINDOWS = ("most_over", "most_under", "max_over", "max_under")
SERVED: dict = {}


def info(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def model_key(index, spec: dict = SPEC) -> str:
    """A digest of what the model is made of: the genome's packed words,
    the index's rules (k, buckets, its table's windows, prefix arrays) and
    the spec."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(index.packed).tobytes())
    t = index.table
    h.update(json.dumps({
        "n": int(index.n), "k": int(index.k), "buckets": int(index.buckets),
        "table": [int(t.most_over), int(t.most_under), int(t.max_over),
                  int(t.max_under)],
        "prefix_arrays": index.prefix3 is not None,
        "spec": spec}, sort_keys=True).encode())
    return h.hexdigest()[:16]


def trained_by(spec: dict) -> bool:
    """Whether train_serving trains the spec's model: one hidden layer
    in float64, and the spec's convergence rule Trainer.fit's."""
    fit = inspect.signature(Trainer.fit).parameters
    return (spec["hidden_layers"] == 1 and spec["precision"] == "float64"
            and spec["convergence_window"]
            == fit["convergence_window"].default
            and spec["convergence_threshold"]
            == fit["convergence_threshold"].default)


def served_model(index, cache_dir: str, spec: dict = SPEC):
    """The spec's model of this index on the index's device: loaded from
    `cache_dir`/nn/ where a run of this checkout saved it, else trained
    and saved there (whole, then renamed into place)."""
    if not trained_by(spec):
        raise ValueError(f"the program does not train the model {spec}")
    path = os.path.join(cache_dir, "nn", f"{model_key(index, spec)}.npz")
    t = time.perf_counter()
    if os.path.exists(path):
        srv, how = load_serving(path, index.device), "loaded"
    else:
        srv = train_serving(index, num_chunks=spec["chunks"],
                            layer_size=spec["units"], epochs=spec["epochs"],
                            seed=spec["seed"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_serving(srv, path)
        how = "trained"
    SERVED.clear()
    SERVED.update(how=how, path=path, epochs_run=srv.epochs_run,
                  early_stopped=srv.early_stopped, chunks=len(srv.xb),
                  **{w: getattr(srv, w) for w in WINDOWS})
    info(f"nn model {how} in {time.perf_counter() - t:.3f} s ({path}): "
         f"windows most +{srv.most_over} -{srv.most_under}, max "
         f"+{srv.max_over} -{srv.max_under}; {srv.epochs_run} epochs run, "
         f"{srv.early_stopped}/{len(srv.xb)} chunks early-stopped")
    return srv
