"""The counter metrics of the query kernels' layer (portbench/counted.py
and its readers): their arithmetic on planted counts, silence without
counts, a traced run on the CPU as before, and on the card (`-m cuda`)
every one of them in a traced run's line and none in an untraced one."""

import json
import time

import numpy as np
import pytest
import torch

from portbench import counted, harness
from portbench.harness import Cell, Run, per_layer
from portbench.tests.tiny import CELL, make_root
from portbench.trace_reader import Trace

NEW = {"probes_per_query", "sectors_per_query", "genome_sectors_per_query",
       "bisect_steps_per_query", "lane_use_pct"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("counted")))


@pytest.fixture(scope="module")
def cell(root):
    return Cell.find(root, CELL)


def planted(cell, counts):
    run = Run(cell=cell, k=21, buckets=18, batches={})
    run.counts = counts
    return run


def rows(**values):
    return {name: np.asarray(v, np.int32) for name, v in values.items()}


def two_lengths():
    """Two batches of 64 queries: at L=21 two warps whose probes are one
    a lane but 4 on one lane, and two a lane; at L=101 every count 3."""
    p21 = np.ones(64, np.int32)
    p21[5] = 4
    p21[32:] = 2
    b21 = rows(probes=p21, sectors=2 * p21, c_steps=np.zeros(64),
               d_steps=np.arange(64) % 2, genome_sectors=p21 - 1)
    b101 = rows(**{name: np.full(64, 3) for name in (
        "probes", "sectors", "c_steps", "d_steps", "genome_sectors")})
    return {21: b21, 101: b101}


def test_readers_on_planted_counts(cell):
    """Each per-query reader is the mean of its row over each length's
    batch, the lengths weighted equally, by hand."""
    run = planted(cell, two_lengths())
    p21 = (31 + 4 + 32 * 2) / 64          # 99 probes over 64 queries
    want = {"probes_per_query": (p21 + 3) / 2,
            "sectors_per_query": (2 * p21 + 3) / 2,
            "genome_sectors_per_query": (p21 - 1 + 3) / 2,
            "bisect_steps_per_query": (0.5 + 3) / 2}
    for name, value in want.items():
        got = cell.module("metrics", name).read(run)
        assert got == pytest.approx(value), name
    # the lengths weigh equally whatever their batch sizes
    run = planted(cell, {21: rows(probes=[1, 1, 1, 1]), 31: rows(probes=[3])})
    assert counted.per_query(run, "probes") == 2.0


def test_lane_use_by_hand(cell):
    """Two warps: the first 31 lanes of one probe and one of 4 (35 probes
    in 4 x 32 slots), the second 2 a lane (64 in 2 x 32): 99 of 192 slots;
    the L=101 batch 192 of 192; a batch of 33 is two warps, the second
    padded."""
    assert counted.lane_use(two_lengths()[21]["probes"]) == (99, 192)
    run = planted(cell, two_lengths())
    reader = cell.module("metrics", "lane_use_pct")
    assert reader.read(run) == pytest.approx(100 * (99 + 192) / (192 + 192))
    assert counted.lane_use([2] * 32 + [5]) == (69, 32 * 2 + 32 * 5)


def test_readers_silent_without_counts(cell):
    """No counts (an untraced run, a run on the CPU, an entry without a
    stats call): every new reader returns None. A program that writes no
    row (an older kernel: probes and sectors only) leaves that row's
    metric out and reads the others."""
    untraced = Run(cell=cell, k=21, buckets=18, batches={})
    cpu = Run(cell=cell, k=21, buckets=18, batches={},
              trace=Trace(window=(0.0, 1.0)))
    for run in (untraced, cpu, planted(cell, None), planted(cell, {})):
        for name in NEW:
            assert cell.module("metrics", name).read(run) is None, name
    assert untraced.counts is None and cpu.counts is None
    older = planted(cell, {21: rows(probes=[2, 3], sectors=[5, 6])})
    assert cell.module("metrics", "probes_per_query").read(older) == 2.5
    assert cell.module("metrics", "lane_use_pct").read(older) is not None
    for name in ("genome_sectors_per_query", "bisect_steps_per_query"):
        assert cell.module("metrics", name).read(older) is None


def test_existing_metrics_unchanged(cell):
    """A traced run's per-layer line without counts: every metric it
    reported before the counters, none of them."""
    run = Run(cell=cell, k=21, buckets=18,
              batches={21: np.zeros((10, 21), np.uint8)},
              spans={"index_ready": 0.5}, host_call_s=[1e-4, 3e-4],
              traced=[21],
              trace=Trace(window=(0.0, 1e-3), device_ops=[
                  ("void plquery_kernel<2, int, false>()", 1e-4, 5e-4)]))
    got = per_layer(cell, run)
    assert set(got) == {"index_ready_s", "host_call_us",
                        "plquery_roofline_pct", "device_idle_pct"}
    assert got["host_call_us"]["value"] == pytest.approx(200.0)
    assert got["device_idle_pct"]["value"] == pytest.approx(60.0)


def test_traced_cpu_run_as_before(root, capsys, monkeypatch):
    """A CPU run of the tiny cell at --trace 1 ends as it did before the
    counters: not measured, its profiler saw no card; no counted slice."""
    monkeypatch.setattr(counted, "count_slice", lambda run: pytest.fail(
        "a counted slice without a card"))
    argv = ["--workload", CELL, "--seed", "4300000005", "--seconds", "0.2",
            "--trace", "1"]
    assert harness.main(argv, time.perf_counter(), root,
                        require_card=False) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no operation on the card" in err


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_counters_on_the_card(card, tmp_path, capsys, monkeypatch):
    """The tiny cell at --trace 1 reports all five counter metrics beside
    the others, and each length's deepest phase C and D steps over its
    lanes equal the kernel's own; at --trace 0 the line holds none."""
    root = make_root(str(tmp_path))
    slices = []

    def keep(run):
        slices.append(real(run))
        return slices[-1]

    real = counted.count_slice
    monkeypatch.setattr(counted, "count_slice", keep)
    lines = {}
    for trace in (0, 1):
        argv = ["--workload", CELL, "--seed", "4300000003", "--seconds",
                "0.5", "--trace", str(trace)]
        assert harness.main(argv, time.perf_counter(), root) == 0
        out, err = capsys.readouterr()
        lines[trace] = json.loads(out.strip().splitlines()[-1])
        assert lines[trace]["correct"] is True
    assert not NEW & set(lines[0]["metrics"])
    metrics = lines[1]["metrics"]
    assert NEW <= set(metrics)
    assert {"plquery_roofline_pct", "device_idle_pct", "host_call_us",
            "index_ready_s"} <= set(metrics)
    assert metrics["probes_per_query"]["value"] >= 1
    assert (metrics["genome_sectors_per_query"]["value"]
            <= metrics["sectors_per_query"]["value"])
    assert 0 < metrics["lane_use_pct"]["value"] <= 100
    (counts,) = slices
    assert sorted(counts) == [21, 31, 41, 51, 101]
    for length, r in counts.items():
        assert r["genome_sectors"].sum() <= r["sectors"].sum(), length
        line = [x for x in err.splitlines()
                if x.startswith(f"portbench: counted L={length} ")]
        assert len(line) == 1
        c, d = (int(v) for v in line[0].split("depth C ")[1].split(" D "))
        assert (int(r["c_steps"].max()), int(r["d_steps"].max())) == (c, d)
