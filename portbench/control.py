"""The comparison's control, at a cell's own size, on several seeds.

For each seed it makes the cell's batches as a run does and judges, with
the harness's comparison, the answers of the control: the plain
reference's lookup checking only each query's first k bases
(`reference.kmer_only_answers`), which breaks the guarantee that a
position answered holds the whole query. With `--program 1` it also
judges the program's answers to the same batches (one call each, through
the mix's entry) for the comparison's lower reading. The benchmark's own
runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        [--program 1]

One JSON line a seed and batch on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def main(argv, root: str) -> int:
    import torch

    from portbench.genome import cached_genome, codes_of
    from portbench.harness import PACKAGE, SETUP_THREADS, Cell
    from portbench.index_cache import QUERY_SKIP, ensure_artifact
    from portbench.reference import KeyTable, judge, kmer_only_answers
    from portbench.traffic import LookupTraffic

    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = Cell.find(root, args.workload)
    cache = os.path.join(root, PACKAGE, ".cache")
    genome = codes_of(np.asarray(cached_genome(
        cell.config["genome"], os.path.join(cache, "genome"))))
    k = int(cell.config["index"]["k"])
    index = entry = None
    if args.program:
        from sapling_tpu_torch.index.sapling import SaplingIndex
        artifact, _ = ensure_artifact(root, cache, cell.config,
                                      cell.config_file)
        entry = cell.module("entries", cell.mix["entry"])
        entry.build()
        index = SaplingIndex.load(artifact, skip=QUERY_SKIP, mmap=True,
                                  device=device)
        entry.ready(index)
    g = torch.from_numpy(np.ascontiguousarray(genome)).to(device)
    table, kmer_table = KeyTable(g), KeyTable(g, k)
    for seed in (int(s) for s in args.seeds.split(",")):
        traffic = LookupTraffic(cell.mix, seed)
        for length in traffic.lengths:
            rows_np = traffic.batch(genome, length)
            rows = torch.from_numpy(rows_np).to(device)
            line = {"seed": seed, "length": length,
                    "control": judge(table, rows,
                                     kmer_only_answers(kmer_table, rows))}
            if index is not None:
                with ThreadPoolExecutor(SETUP_THREADS) as pool:
                    inputs = entry.prepare(index, rows_np, pool)
                out = entry.call(index, inputs, length)
                line["program"] = judge(table, rows, out)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = ROOT
    sys.exit(main(sys.argv[1:], ROOT))
