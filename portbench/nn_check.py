"""The NN cell's checks beyond `correct`, at the cell's own size on the
card, on several seeds. The benchmark's own runs never run this.

For each seed it makes the cell's batch as a run does and, with the model
the entry serves (`nn_model.served_model`: loaded where a run of this
checkout trained it):

  * `kernel_vs_reference`: the kernel's predicted ranks
    (`NNServing.predict_ranks`) against the plain reference's
    (`nn_reference.predict_ranks`) in float64: the k-mers more than 1 rank
    apart (0 expected) and the largest difference; and against the
    reference in float32, the precision below the configuration's (the
    comparison's lower reading: more than 0 expected);
  * `outside_window`: the present queries whose run of equal k-mers in
    the suffix array (the ranks whose positions hold the query, found
    from the benchmark's genome and the index's rev) misses [pred -
    max_under, pred + max_over] of the reference's prediction (0
    expected: the audit's windows cover every k-mer);
  * the harness's judgement (`reference.judge`) of the program's answers
    to the batch (one request through the entry); of the program's
    plQuery on the float32 reference's predictions with the model's
    windows (`float32_engine`: the engine computed in the precision below
    the configuration's); and of two controls: the position at the
    reference's predicted rank, unrefined (`prediction_alone`), and the
    reference's lookup of the query's first k - 1 bases (`k_minus_1`);
    and control.py's k-mer-only lookup, exact where the queries are k
    bases long (`kmer_only`).

With `--retrain 1` it also trains the model twice more from the seed on the
index loaded as the harness loads it, and compares the parameters bit for
bit and the windows with the served model's, with each training's seconds
and the card's peak memory during it.

    python3 portbench/nn_check.py --workload <NN cell> --seeds 11,12,13 \\
        [--retrain 1] [--device cpu]

One JSON line a seed (and one for the trainings) on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def rank_runs(genome, rev, k: int):
    """(the sorted k-mers of the ranks whose suffix holds k bases, those
    ranks) on the genome's device, from the benchmark's genome (codes)
    and the index's rev: the suffix array's runs of equal k-mers are the
    ranges of equal keys."""
    import torch

    from portbench.reference import _keys

    n = genome.shape[0]
    keys = _keys(genome, k, n - k + 1)
    full = torch.nonzero(rev <= n - k).flatten()
    by_rank = keys[rev[full]]
    if not bool((by_rank[1:] >= by_rank[:-1]).all()):
        raise AssertionError("rev does not sort the genome's k-mers")
    return by_rank, full


def outside_window(by_rank, full, kmers, pred, max_over: int,
                   max_under: int) -> tuple[int, int]:
    """(present queries, those whose run misses [pred - max_under, pred +
    max_over])."""
    import torch

    lo = torch.searchsorted(by_rank, kmers)
    hi = torch.searchsorted(by_rank, kmers, right=True)
    present = hi > lo
    first = full[lo.clamp(max=full.shape[0] - 1)]
    last = full[(hi - 1).clamp(min=0)]
    miss = present & ((last < pred - max_under) | (first > pred + max_over))
    return int(present.sum()), int(miss.sum())


def main(argv, root: str) -> int:
    import torch

    from portbench import nn_model, nn_reference
    from portbench.genome import cached_genome, codes_of
    from portbench.harness import PACKAGE, SETUP_THREADS, Cell
    from portbench.index_cache import QUERY_SKIP, ensure_artifact
    from portbench.reference import KeyTable, judge, kmer_only_answers
    from portbench.traffic import LookupTraffic
    from sapling_tpu_torch.index.sapling import SaplingIndex
    from sapling_tpu_torch.ops.query_cuda import plquery_cuda

    p = argparse.ArgumentParser(prog="portbench/nn_check.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--retrain", type=int, default=0)
    # the CPU at a tiny size, to rehearse (the kernels run only on a card)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("nn_check: no CUDA device", file=sys.stderr)
        return 2
    cell = Cell.find(root, args.workload)
    cache = os.path.join(root, PACKAGE, ".cache")
    genome = codes_of(np.asarray(cached_genome(
        cell.config["genome"], os.path.join(cache, "genome"))))
    k = int(cell.config["index"]["k"])
    artifact, _ = ensure_artifact(root, cache, cell.config, cell.config_file)
    entry = cell.module("entries", cell.mix["entry"])
    if device.type == "cuda":
        entry.build()
    index = SaplingIndex.load(artifact, skip=QUERY_SKIP, mmap=True,
                              device=device)
    entry.ready(index)
    srv = index.nn_engine.srv
    g = torch.from_numpy(np.ascontiguousarray(genome)).to(device)
    rev = index.device_arrays()["rev"][:index.n].to(torch.int64) \
        & 0xFFFFFFFF
    by_rank, full = rank_runs(g, rev, k)
    arrays = index.device_arrays()
    windows = {w: getattr(srv, w) for w in nn_model.WINDOWS}

    def plquery_on(x, q3, q_words, pred):
        """The program's plQuery of k-base queries on these predictions,
        with the model's windows."""
        return plquery_cuda(
            arrays["packed"], arrays["rev"], arrays["xlist"], arrays["ylist"],
            q_words, x, arrays["prefix64"], arrays["prefix3"], q3, n=index.n,
            length=k, k=k, buckets=index.buckets, pred64=pred,
            rank_recs=index.query_records()[1], **windows)

    table, kmer_table, short_table = (KeyTable(g), KeyTable(g, k),
                                      KeyTable(g, k - 1))
    for seed in (int(s) for s in args.seeds.split(",")):
        traffic = LookupTraffic(cell.mix, seed)
        for length in traffic.lengths:
            rows_np = traffic.batch(genome, length)
            rows = torch.from_numpy(rows_np).to(device)
            with ThreadPoolExecutor(SETUP_THREADS) as pool:
                inputs = entry.prepare(index, rows_np, pool)
            x = inputs[0]
            kernel = srv.predict_ranks(x)
            ref = nn_reference.predict_ranks(srv, x)
            low = nn_reference.predict_ranks(srv, x, torch.float32)
            d64, d32 = (kernel - ref).abs(), (kernel - low).abs()
            present, outside = outside_window(by_rank, full, x, ref,
                                              srv.max_over, srv.max_under)
            line = {
                "seed": seed, "length": length, "queries": len(rows_np),
                "kernel_vs_reference": {
                    "float64_over_1": int((d64 > 1).sum()),
                    "float64_max": int(d64.max()),
                    "float32_over_1": int((d32 > 1).sum()),
                    "float32_max": int(d32.max())},
                "present": present, "outside_window": outside,
                "program": judge(table, rows,
                                 entry.call(index, inputs, length)),
                "float32_engine": judge(table, rows, plquery_on(
                    x, inputs[1], inputs[2], low)),
                "prediction_alone": judge(table, rows, rev[ref]),
                "k_minus_1": judge(table, rows,
                                   kmer_only_answers(short_table, rows)),
                "kmer_only": judge(table, rows,
                                   kmer_only_answers(kmer_table, rows))}
            print(json.dumps(line), flush=True)
            del inputs
    if args.retrain:
        from sapling_tpu_torch.models.serve import train_serving

        spec = nn_model.SPEC
        runs = []
        cuda = device.type == "cuda"
        for _ in range(2):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
            t = time.perf_counter()
            other = train_serving(
                index, num_chunks=spec["chunks"], layer_size=spec["units"],
                epochs=spec["epochs"], seed=spec["seed"])
            if cuda:
                torch.cuda.synchronize()
            runs.append({
                "seconds": time.perf_counter() - t,
                "peak_bytes": (torch.cuda.max_memory_allocated(device)
                               if cuda else 0),
                "params_equal": all(
                    a[n].equal(b[n]) for a, b in zip(other.params,
                                                     srv.params)
                    for n in ("w", "b")) and other.xb.equal(srv.xb),
                "windows_equal": all(getattr(other, w) == getattr(srv, w)
                                     for w in nn_model.WINDOWS),
                "epochs_run": other.epochs_run,
                "early_stopped": other.early_stopped})
            del other
            if cuda:
                torch.cuda.empty_cache()
        print(json.dumps({"retrained": runs, "served": nn_model.SERVED}),
              flush=True)
    return 0


if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = ROOT
    sys.exit(main(sys.argv[1:], ROOT))
