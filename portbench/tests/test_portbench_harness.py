"""The harness on the CPU at a tiny size: it refuses to measure without a
card, finds a cell's files by name, and its `correct` comes out false
under each fault that a lookup run can have."""

import json
import time

import pytest
import torch

from portbench import harness
from portbench.harness import Cell, Run, forbidden_modules, per_layer
from portbench.tests.tiny import (CELL, CONFIG, MIX, TINY_B, TINY_N,
                                  control_call, make_root)

PROBE = '''"""a test metric: the number of batches the run made"""


def read(run):
    return float(len(run.batches))
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")),
                     {"probe_metric": PROBE})


def run(root, capsys, seed=4_100_000_001, wrap_call=None, card=False):
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "0.3"]
    rc = harness.main(argv, time.perf_counter(), root, require_card=card,
                      wrap_call=wrap_call)
    out, err = capsys.readouterr()
    return rc, out, err


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "sapling_tpu", "sapling_tpu.ops.query", "sapling_tpu_torch",
             "sapling_tpu_torch.ops", "jaxtyping", "jax_cosmo", "numpy"]
    assert forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "sapling_tpu", "sapling_tpu.ops.query"]


def test_no_card_no_result(root, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(root, capsys, card=True)
    assert rc != 0 and out == ""
    assert "no CUDA device" in err


def test_too_few_cards_no_result(root, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc, out, err = run(root, capsys, card=True)
    assert rc != 0 and out == ""


def test_files_found_by_name(root):
    cell = Cell.find(root, CELL)
    assert cell.config["name"] == CONFIG
    assert cell.config["genome"]["length"] == TINY_N
    assert cell.mix["queries_per_request"] == TINY_B
    assert cell.workload["traffic"] == MIX
    names = [m["name"] for m in cell.metrics("per_layer")]
    assert "probe_metric" in names
    r = Run(cell=cell, k=21, buckets=18, batches={21: None})
    assert per_layer(cell, r)["probe_metric"]["value"] == 1.0
    with pytest.raises(harness.NotRunnable):
        Cell.find(root, "no-such-cell")


def test_sound_run_is_correct(root, capsys):
    rc, out, err = run(root, capsys)
    assert rc == 0
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"lookup_qps", "lookup_p95_ms",
                                      "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["attempted"] > 0 and result["failed"] == 0
    # the numbers compared are the last lines on standard error
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[1] for line in last] == list(result["checks"])


def altered(call):
    """One answer of each request moved by one position."""
    def wrapped(index, inputs, length):
        out = call(index, inputs, length).clone()
        i = int(torch.nonzero(out >= 0)[0])
        out[i] += 1
        return out
    return wrapped


def half_left_out(call):
    """The second half of each batch left unanswered."""
    def wrapped(index, inputs, length):
        out = call(index, inputs, length).clone()
        out[out.shape[0] // 2:] = -1
        return out
    return wrapped


def stale(call):
    """Each request answered with the previous request's answers."""
    last = []

    def wrapped(index, inputs, length):
        out = call(index, inputs, length)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return wrapped


@pytest.mark.parametrize("fault", [altered, half_left_out, stale])
def test_faults_are_not_correct(root, capsys, fault):
    rc, out, _ = run(root, capsys, wrap_call=fault)
    assert rc == 0
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("seed", [4_100_000_001, 4_400_000_001])
def test_control_is_not_correct(root, capsys, seed):
    """The control (the reference's k-mer-only lookup) in the program's
    place, through a whole run, comes out not correct."""
    rc, out, _ = run(root, capsys, seed=seed,
                     wrap_call=control_call(root, seed))
    assert rc == 0
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] > 0


def test_another_bucket_count_is_not_measured(root, capsys, monkeypatch):
    """An index whose bucket count is not the configuration's rule is
    another deployment: no result."""
    monkeypatch.setattr(harness, "buckets_for", lambda n, max_mem: 30)
    rc, out, err = run(root, capsys)
    assert rc != 0 and out == ""
    assert "buckets" in err
