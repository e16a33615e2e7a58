"""The port stands without JAX; chip_smoke.py and chip_measure.py refuse to
run without a GPU.

Each check runs a fresh interpreter, so nothing this test process has
imported (it imports jax through the other test files) can leak in.
"""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import sapling_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    sapling_tpu_torch.__path__, "sapling_tpu_torch.")]
for name in names:
    importlib.import_module(name)
tools = ("sapling_example", "binarysearch", "build_big_index",
         "retable_index", "swap_table_artifact", "add_bucket_bounds",
         "bench_query_scale", "bench_align", "bench_sweep", "nn_pipeline",
         "bench_nn_query", "query_big_split", "bench_align_ab",
         "gen_perf_table", "ref_to_suffix_array", "microbench_gather")
evalx = ("memory", "sa_sample", "kmer_stats", "bins", "alignment_quality",
         "plots")
assert {f"sapling_tpu_torch.tools.{t}" for t in tools} | {
    f"sapling_tpu_torch.evalx.{e}" for e in evalx} | {
    "sapling_tpu_torch.utils.profiling",
    "sapling_tpu_torch.models.residual",
    "sapling_tpu_torch.models.serve", "sapling_tpu_torch.graft_entry",
    "sapling_tpu_torch.ops.query_cuda", "sapling_tpu_torch.ops.nn_predict_cuda",
    "sapling_tpu_torch.parallel.mesh", "sapling_tpu_torch.parallel.query",
    "sapling_tpu_torch.parallel.sharded_index",
    "sapling_tpu_torch.parallel.multihost"} <= set(names), names
import chip_smoke, chip_measure
leaked = sorted(m for m in sys.modules
                if m in ("jax", "optax")
                or m.startswith(("jax.", "optax.", "sapling_tpu.")))
print(len(names), leaked)
assert not leaked, leaked
"""


# a rank spawned by the port's launcher (tests/torch_dist_worker.py
# imports the port only) holds no jax either
_SPAWNED_RANK = """
import sys, tempfile
from sapling_tpu_torch.parallel.multihost import spawn_ranks
from tests import torch_dist_worker
with tempfile.TemporaryDirectory() as td:
    leaked = spawn_ranks(torch_dist_worker.leaked_modules, 2,
                         "file://" + td + "/rendezvous", "gloo")
print(leaked)
assert leaked == [[], []], leaked
"""


def _run(args, cwd, env_extra=None):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    res = _run(["-c", _IMPORT_ALL], ROOT)
    assert res.returncode == 0, res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 20


def test_spawned_rank_imports_no_jax():
    res = _run(["-c", _SPAWNED_RANK], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[[], []]"


def test_chip_smoke_fails_without_a_gpu():
    res = _run(["chip_smoke.py"], ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "torch.cuda.is_available() is false" in res.stderr


def test_chip_measure_fails_without_a_gpu(tmp_path):
    out = tmp_path / "measure.json"
    res = _run(["chip_measure.py", str(out)], ROOT,
               {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and not out.exists()
    assert "torch.cuda.is_available() is false" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the program is missing: the script must fail and print no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "sapling_tpu_torch" in res.stderr
