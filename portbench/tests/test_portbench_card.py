"""The harness end to end on the card at the tiny size (run on the
chip: `python -m pytest portbench/tests -m cuda`)."""

import json
import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import CELL, control_call, make_root


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_on_the_card(card, tmp_path, capsys, trace):
    root = make_root(str(tmp_path))
    argv = ["--workload", CELL, "--seed", "4300000001", "--seconds", "0.5",
            "--trace", str(trace)]
    assert harness.main(argv, time.perf_counter(), root) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
        assert {"plquery_roofline_pct", "device_idle_pct",
                "host_call_us", "index_ready_s"} <= set(result["metrics"])
        assert 0 < result["metrics"]["plquery_roofline_pct"]["value"] <= 100


@pytest.mark.cuda
def test_control_on_the_card_is_not_correct(card, tmp_path, capsys):
    """The control in the program's place comes out not correct."""
    root = make_root(str(tmp_path))
    seed = 4300000002
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "0.5"]
    assert harness.main(argv, time.perf_counter(), root,
                        wrap_call=control_call(root, seed, "cuda")) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] > 0
