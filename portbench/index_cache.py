"""The program's index artifact of a configuration, built once in a
checkout.

The first run of a configuration in a checkout builds the index on the
host, in a child process that never touches the card (the program's
builders fork workers), and saves it under the benchmark's cache. Later
runs load it memory-mapped. The artifact is the program's own format,
written by the program; the benchmark only keeps it.

Run as `python -m portbench.index_cache <config file> <cache dir>`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

from .genome import cached_genome, spec_digest

# members a lookup never reads, left out of the load
QUERY_SKIP = ("inv", "codes", "lcpk_fwd", "lcpk_bwd")


def artifact_path(cache_dir: str, config: dict) -> str:
    key = spec_digest({"genome": config["genome"], "index": config["index"]})
    return os.path.join(cache_dir, "index", f"{config['name']}-{key}.stpu.npz")


def index_config(config: dict):
    """The program's IndexConfig of a configuration's `index` object."""
    from sapling_tpu_torch.config import IndexConfig

    spec = config["index"]
    return IndexConfig(k=int(spec["k"]), buckets=-1,
                       max_mem=int(spec["max_mem"]),
                       most_threshold=float(spec["most_threshold"]),
                       prefix_lookup=bool(spec["prefix_arrays"]))


def build(config_file: str, cache_dir: str) -> None:
    """Build the configuration's index on the host and save it to its
    artifact_path without the members a lookup never reads."""
    import numpy as np

    from sapling_tpu_torch.index.sapling import SaplingIndex

    with open(config_file) as f:
        config = json.load(f)
    out = artifact_path(cache_dir, config)
    genome = np.asarray(cached_genome(config["genome"],
                                      os.path.join(cache_dir, "genome")))
    idx = SaplingIndex.build(
        genome, index_config(config),
        keep_aligner_arrays=bool(config["index"]["aligner_arrays"]),
        device="cpu")
    idx = dataclasses.replace(idx, inv=np.zeros(0, idx.rev.dtype),
                              codes=None)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    idx.save(out)


def ensure_artifact(root: str, cache_dir: str, config: dict,
                    config_file: str) -> tuple[str, bool]:
    """(the artifact's path, whether this call built it)."""
    out = artifact_path(cache_dir, config)
    if os.path.exists(out):
        return out, False
    # the child imports this package and the program from where this
    # process found them
    code_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (code_root, os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run(
        [sys.executable, "-m", "portbench.index_cache", config_file,
         cache_dir], cwd=root, env=env, capture_output=True, text=True)
    if res.returncode != 0 or not os.path.exists(out):
        raise RuntimeError(f"index build failed ({res.returncode}):\n"
                           f"{res.stdout[-4000:]}{res.stderr[-4000:]}")
    return out, True


if __name__ == "__main__":
    build(sys.argv[1], sys.argv[2])
