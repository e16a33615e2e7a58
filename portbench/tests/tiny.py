"""A tiny copy of the benchmark for the CPU tests: a root holding a
BENCHMARK.json and the benchmark's own configuration, mix, entry and
metric files, with a genome of TINY_N bases and batches of TINY_B
queries under new names."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
TINY_N, TINY_B = 30_000, 2_000
CONFIG, MIX, CELL = "tiny-genome", "tiny-mix", "tiny-genome.tiny-mix"


def read(rel: str) -> dict:
    with open(os.path.join(REPO, rel)) as f:
        return json.load(f)


def make_root(root: str, extra_metrics: dict | None = None) -> str:
    """Write the tiny benchmark under `root`; extra_metrics maps a metric
    name to the source of its reader, added to the cell's per-layer
    metrics."""
    bench = read("BENCHMARK.json")
    config = read("portbench/configs/ecoli-4.6M-k21.json")
    config.update(name=CONFIG)
    config["genome"]["length"] = TINY_N
    mix = read("portbench/traffic/lookup-mix.json")
    mix["queries_per_request"] = TINY_B
    for folder in ("entries", "metrics"):
        shutil.copytree(os.path.join(PKG, folder),
                        os.path.join(root, "portbench", folder))
    for rel, obj in ((f"portbench/configs/{CONFIG}.json", config),
                     (f"portbench/traffic/{MIX}.json", mix)):
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        with open(os.path.join(root, rel), "w") as f:
            json.dump(obj, f)
    bench["configs"] = [{"name": CONFIG, "source": "test", "reduced": [],
                         "file": f"portbench/configs/{CONFIG}.json",
                         "why": "test"}]
    bench["workloads"] = [{"name": CELL, "config": CONFIG, "traffic": MIX,
                           "chips": 1, "why": "test"}]
    for m in bench["per_layer"]:
        m["workloads"] = [CELL]
    for name, source in (extra_metrics or {}).items():
        with open(os.path.join(root, "portbench", "metrics", f"{name}.py"),
                  "w") as f:
            f.write(source)
        bench["per_layer"].append(
            {"name": name, "unit": "1", "better": "higher",
             "source": "program_counter", "layer": "test",
             "moves": "lookup_qps", "workloads": [CELL]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def control_call(root: str, seed: int, device: str = "cpu"):
    """A `wrap_call` that puts the comparison's control in the program's
    place: each request of a run of the tiny cell with `seed` is answered
    by the reference's lookup of its batch's first k bases alone
    (`reference.kmer_only_answers`)."""
    import torch

    from portbench.genome import cached_genome, codes_of
    from portbench.harness import PACKAGE, Cell
    from portbench.reference import KeyTable, kmer_only_answers
    from portbench.traffic import LookupTraffic

    cell = Cell.find(root, CELL)
    codes = codes_of(np.asarray(cached_genome(
        cell.config["genome"], os.path.join(root, PACKAGE, ".cache",
                                            "genome"))))
    traffic = LookupTraffic(cell.mix, seed)
    table = KeyTable(torch.from_numpy(codes).to(device),
                     int(cell.config["index"]["k"]))
    answers = {}

    def wrap(call):
        def wrapped(index, inputs, length):
            if length not in answers:
                rows = torch.from_numpy(traffic.batch(codes, length))
                answers[length] = kmer_only_answers(table, rows.to(device))
            return answers[length]
        return wrapped
    return wrap
