"""The NN engine entry: Sapling's learned index with 64 per-chunk MLPs as
its rank predictor (`sapling_tpu_torch.models.serve.NNQueryEngine`), over
prepared device inputs (`NNQueryEngine.query_inputs`, then
`query_device`); k-base queries only, as the model predicts k-mers.

`ready` gives the index its engine as `index.nn_engine`, so that the
engine lives as long as the index does, with the model of
`portbench.nn_model.served_model` (trained once a checkout, then loaded),
and makes its two plans before the first request. `portbench.nn_model`
imports the program's model saving and loading when this module is
loaded, so that a program without them fails at once, before the genome
and the index are made. The module adds its stats call to
`portbench.counted.STATS_CALLS`.

`prepare` holds the served predictions of each batch to the plain float64
reference (`portbench.nn_reference`) within 1 rank, and fails the run
where one lies further: the configuration states float64, and a
prediction made in float32 lies up to 16 ranks off at 10^8 ranks while
the audited windows still cover it, so the harness's judgement of the
positions alone would not see it.
"""

from __future__ import annotations

import os

import torch
from sapling_tpu_torch.models.serve import NNQueryEngine

from portbench import counted, nn_model, nn_reference

# rows the program packs at a time in set-up, on the harness's threads
CHUNK = 1 << 18
# ranks a served prediction may lie from the float64 reference's (the
# reference sums in another order, so a row on a rounding edge may round
# the other way)
RANK_LIMIT = 1
# the benchmark's cache, beside the index artifact
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".cache")


class NotTheModel(RuntimeError):
    """The engine's predictions are not the configuration's model's."""


def build() -> None:
    """Build the program's query and NN kernels (a first run compiles
    them)."""
    from sapling_tpu_torch.ops import nn_predict_cuda, query_cuda
    from sapling_tpu_torch.ops.sw_cuda import build_kernel
    build_kernel(query_cuda.SOURCE)
    build_kernel(nn_predict_cuda.SOURCE)


def ready(index) -> None:
    """Make the device arrays, the rank records and the engine the calls
    read, and on the card the engine's two plans."""
    index.device_arrays()
    index.query_records()
    srv = nn_model.served_model(index, CACHE)
    engine = index.nn_engine = NNQueryEngine(index, srv)
    if index.device.type == "cuda":
        engine.srv.plan()
        engine.plan()
        nn_model.info(f"nn engine: plans made {engine.counts['plans']}, "
                      "and the model's serving plan")
        # training's transients go back to the card
        torch.cuda.empty_cache()


def prepare(index, rows, pool):
    """The device inputs of a batch of k-base query codes (uint8 [B, k]),
    packed in chunks on the executor `pool`, once the batch's predictions
    have passed check_predictions."""
    parts = list(pool.map(index.nn_engine.query_inputs,
                          (rows[i:i + CHUNK]
                           for i in range(0, rows.shape[0], CHUNK))))
    x = torch.cat([p[0] for p in parts])
    q3 = None if parts[0][1] is None else torch.cat([p[1] for p in parts])
    words = (None if parts[0][2] is None
             else torch.cat([p[2] for p in parts], dim=1))
    check_predictions(index.nn_engine, x)
    return x, q3, words


def check_predictions(engine, x) -> None:
    """Raise NotTheModel unless the engine's predicted ranks of the k-mers
    x, by the path its requests take, lie within RANK_LIMIT of the plain
    float64 reference's."""
    with torch.no_grad():
        pred = engine.srv.predict_ranks(x)
    largest, over = nn_reference.rank_gap(engine.srv, x, pred, RANK_LIMIT)
    nn_model.info(f"nn predictions of {x.shape[0]} queries against the "
                  f"float64 reference: {over} more than {RANK_LIMIT} rank "
                  f"apart (limit 0), the largest gap {largest}")
    if over:
        raise NotTheModel(
            f"{over} of {x.shape[0]} predicted ranks lie more than "
            f"{RANK_LIMIT} from the float64 reference's (the largest "
            f"{largest}): not the configuration's float64 model")


def call(index, inputs, length: int):
    """One request: int64 [B] positions on the index's device."""
    return index.nn_engine.query_device(*inputs)


counted.STATS_CALLS["nn_engine"] = (
    lambda index, inputs, length: index.nn_engine.query_device(
        *inputs, stats=True))
