"""Learned-residual research pipeline: sample -> preprocess -> fit -> test
(PyTorch port; the twin of tools/nn_pipeline.py).

One command replacing the reference's four-stage NN/ pipeline
(reference: NN/sampleSa.cpp + sort/awk preprocessing per NN/README.md:11-27,
NN/preprocess.py, NN/fit.py — one process PER chunk —, NN/test.py):

    python -m sapling_tpu_torch.tools.nn_pipeline <genome.fa> [k=21]
        [chunks=100] [layer_size=8] [hidden_layers=1] [epochs=500]
        [batch=0] [out=<dir>] [device=cuda]

All chunks train simultaneously on the device (models.residual, float64);
prints the same error metrics in suffix-array rows that NN/test.py
reports (mean + percentiles). With out=, writes loss.npy and model.npz
(members p{i}_w, p{i}_b: the JAX tool's names and shapes). The index is
cached beside the FASTA as the JAX tool caches it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..config import IndexConfig, parse_keyval_args
from ..evalx.sa_sample import sample_sa
from ..index.sapling import SaplingIndex
from ..models import residual

# the JAX tool's cut-off, kept as is: full-batch training holds several
# [chunks, points per chunk, layer_size] float64 tensors an epoch (1 GiB
# each at 2^24 points of 8 units); where full batch stops fitting on a
# GPU has not been measured
FULL_BATCH_MAX = 1 << 24


def main(argv):
    if len(argv) < 2:
        print(__doc__)
        return 1
    kv = parse_keyval_args(argv[2:])
    k = int(kv.get("k", 21))
    chunks = int(kv.get("chunks", 100))
    layer = int(kv.get("layer_size", 8))
    hidden = int(kv.get("hidden_layers", 1))
    epochs = int(kv.get("epochs", 500))
    batch = int(kv.get("batch", 0)) or None
    out = kv.get("out")
    device = kv.get("device", "cuda")

    idx = SaplingIndex.from_fasta(argv[1], IndexConfig(k=k), device=device)
    ranks, kmers = sample_sa(idx.codes, idx.inv, k=k)
    print(f"sampled {kmers.shape[0]} (rank, kmer) pairs")
    ds = residual.prepare_dataset(kmers, ranks, chunks)
    print(f"dataset: {ds.x.shape[0]} chunks x {ds.x.shape[1]} points")
    if batch is None and ds.x.size > FULL_BATCH_MAX:
        # fall back to the reference's own minibatch regime (NN/fit.py
        # batch=64; bigger here since all chunks train in one step)
        batch = 2048
        print(f"dataset too large for full-batch training on one device; "
              f"using batch={batch} (override with batch=N)")
    trainer = residual.Trainer.create(
        0, num_chunks=ds.x.shape[0], layer_size=layer,
        hidden_layers=hidden, device=device)
    losses = trainer.fit(ds, epochs=epochs, batch=batch,
                         log=lambda m: print(m, flush=True))
    stopped = int((trainer.stop_epochs >= 0).sum())
    print(f"trained {len(losses)} epochs, final mean loss "
          f"{losses[-1].mean():.6f} ({stopped}/{losses.shape[1]} chunks "
          f"early-stopped)")
    rows = trainer.predict_rows(ds)
    order = np.argsort(kmers, kind="stable")
    true_rows = ranks[order].astype(np.float64)
    metrics = residual.error_percentiles(rows, true_rows)
    for key, v in metrics.items():
        print(f"  {key}: {v:,.1f} rows")
    if out:
        os.makedirs(out, exist_ok=True)
        np.save(os.path.join(out, "loss.npy"), losses)
        np.savez(os.path.join(out, "model.npz"),
                 **{f"p{i}_{n}": layer_p[n]
                    for i, layer_p in enumerate(
                        residual.params_to_numpy(trainer.params))
                    for n in ("w", "b")})
        print(f"wrote {out}/loss.npy and {out}/model.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
