"""utils/profiling.py (the twin of sapling_tpu/utils/profiling.py) on the
CPU: the fenced timer, a torch.profiler trace written to disk, the JSON
event log (the same records as JAX's), and bench_fn's warm-up and
minimum."""

import io
import json
import os

import pytest
import torch

from sapling_tpu.utils import profiling as jprof
from sapling_tpu_torch.utils import profiling


def test_log_event_matches_jax():
    ours, theirs = io.StringIO(), io.StringIO()
    profiling.log_event("timer", stream=ours, name="x", seconds=1.5)
    jprof.log_event("timer", stream=theirs, name="x", seconds=1.5)
    a, b = json.loads(ours.getvalue()), json.loads(theirs.getvalue())
    assert abs(a.pop("t") - b.pop("t")) < 5
    assert a == b == {"kind": "timer", "name": "x", "seconds": 1.5}


def test_device_timer(capsys):
    x = torch.arange(1000)
    with profiling.device_timer("sum", sink={"n": 1000},
                                pending=[x, {"y": x}]) as t:
        t["result"] = (x * x).sum()
    assert t["seconds"] > 0
    rec = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert rec["kind"] == "timer" and rec["name"] == "sum"
    assert rec["n"] == 1000 and rec["seconds"] == t["seconds"]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.profile_trace(d) as tr:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert os.path.dirname(tr["path"]) == d
    with open(tr["path"]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert tr["kernels"] == 0                    # no card: CPU activity


def test_profile_trace_refuses_a_trace_without_card_activity(
        tmp_path, monkeypatch):
    """With a card, kernel launches on the host and no kernel on the
    device mean the profiler lost the card's activity: that raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profiling, "_trace_counts", lambda path: (0, 3))
    with pytest.raises(RuntimeError, match="3 kernel launches"):
        with profiling.profile_trace(str(tmp_path)):
            torch.ones(8).sum()


def test_bench_fn_warms_up_and_takes_the_minimum():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a + b

    best, out = profiling.bench_fn(fn, torch.ones(3), torch.ones(3),
                                   warmup=2, iters=4)
    assert len(calls) == 6
    assert torch.equal(out, torch.full((3,), 2.0))
    assert 0 < best < 1
