"""The roofline's byte counts, counted by hand, and the trace reader."""

import json

import numpy as np
import pytest

from portbench import roofline
from portbench.harness import Cell, Run
from portbench.tests.tiny import CELL, make_root
from portbench.trace_reader import Trace, read_trace


def rows_of(*texts):
    lut = {"A": 0, "C": 1, "G": 2, "T": 3}
    return np.array([[lut[c] for c in t] for t in texts], dtype=np.uint8)


def test_bytes_by_hand():
    # three 21-base queries, two words of 16 bases each; with 4 buckets a
    # k-mer's bucket is its first two bases: AA -> 0, AA -> 0, CA -> 4, so
    # checkpoints 0, 1, 4, 5
    rows = rows_of("A" * 21, "AAC" + "G" * 18, "CA" + "T" * 19)
    assert roofline.io_bytes(rows) == 3 * (2 * 8 + 8)
    assert roofline.checkpoints(rows, 21, 4) == 4
    assert roofline.plquery_bytes(rows, 21, 4) == 72 + 3 * 8 + 4 * 16
    assert roofline.binsearch_bytes(rows) == 72
    # 101 bases take 7 words of 16
    long = np.zeros((5, 101), dtype=np.uint8)
    assert roofline.io_bytes(long) == 5 * (7 * 8 + 8)
    # adjacent buckets share a checkpoint: AA.. and AC.. -> 0, 1, 2
    assert roofline.checkpoints(rows_of("A" * 21, "AC" + "A" * 19),
                                21, 4) == 3


def test_buckets_rule():
    assert roofline.buckets_for(4_600_000, 10) == 18
    assert roofline.buckets_for(100_000_000, 10) == 23


def trace_of(kernels, window=(0.0, 1e-3)):
    return Trace(window=window, device_ops=kernels,
                 host_ops=[("portbench.wait", *window)])


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    return Cell.find(make_root(str(tmp_path_factory.mktemp("r"))), CELL)


def test_share_does_not_depend_on_the_design(tiny_cell):
    """The least bytes come from the queries alone: two designs that
    answer the same requests, one in one launch, one in two launches of
    half the time each, read the same share; a kernel of another name
    leaves the metric out."""
    rng = np.random.default_rng(1)
    batches = {21: rng.integers(0, 4, (1000, 21), dtype=np.uint8),
               101: rng.integers(0, 4, (1000, 101), dtype=np.uint8)}
    traced = [21, 101, 21]
    reader = tiny_cell.module("metrics", "plquery_roofline_pct")
    least = sum(roofline.plquery_bytes(batches[k], 21, 18) for k in traced)

    def share(kernels):
        run = Run(cell=tiny_cell, k=21, buckets=18, batches=batches,
                  traced=traced, trace=trace_of(kernels))
        return reader.read(run)

    one = share([("void plquery_kernel<2, int, false>(long const*)",
                  1e-4, 4e-4)])
    two = share([("_Z14plquery_kernelILi2EiLb1EEvPKx", 1e-4, 2.5e-4),
                 ("_Z14plquery_kernelILi2EiLb1EEvPKx", 5e-4, 6.5e-4)])
    assert one == pytest.approx(100 * least / roofline.HBM_BYTES_PER_S
                                / 3e-4)
    assert two == pytest.approx(one)
    assert share([("fancy_binsearch_kernel", 1e-4, 4e-4)]) is None
    bs = tiny_cell.module("metrics", "binsearch_roofline_pct")
    run = Run(cell=tiny_cell, k=21, buckets=18, batches=batches,
              traced=traced,
              trace=trace_of([("void fancy_binsearch_kernel<1>()", 0, 1e-4),
                              ("void binsearch_kernel<int>()", 2e-4, 4e-4)]))
    want = sum(roofline.binsearch_bytes(batches[k]) for k in traced)
    assert bs.read(run) == pytest.approx(100 * want
                                         / roofline.HBM_BYTES_PER_S / 2e-4)


def test_read_trace(tmp_path):
    us = 1e-6
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.traced",
         "ts": 1000, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.call",
         "ts": 1000, "dur": 150},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1100, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.wait",
         "ts": 1150, "dur": 850},
        {"ph": "X", "cat": "kernel", "name": "plquery_kernel", "ts": 1200,
         "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "plquery_kernel", "ts": 1350,
         "dur": 150},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1900,
         "dur": 300},
        {"ph": "X", "cat": "kernel", "name": "plquery_kernel", "ts": 100,
         "dur": 50},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1300},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = read_trace(str(path), "portbench.traced")
    assert t.window_s == pytest.approx(1000 * us)
    assert t.launches == 1
    # 1200-1500 and 1900-2000 (clipped at the window's end)
    assert t.busy_s() == pytest.approx(400 * us)
    assert t.kernel_seconds(lambda n: "plquery" in n) == (
        2, pytest.approx(350 * us))
    # 1000-1200 named by the innermost host event at its middle, the
    # launch; 1500-1900 by the wait
    gaps = dict(t.idle_gaps())
    assert gaps == {"cudaLaunchKernel": pytest.approx(200 * us),
                    "portbench.wait": pytest.approx(400 * us)}
    assert t.top_device_ops()[0] == ["plquery_kernel",
                                     pytest.approx(350 * us)]
    with pytest.raises(ValueError):
        read_trace(str(path), "another window")
