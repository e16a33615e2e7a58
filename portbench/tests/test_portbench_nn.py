"""The NN engine's cell on the CPU at the tiny size (tiny.py's genome): the
entry's spec is the configuration's model, the plain reference of the
NN's prediction matches the program's within one rank (and a float32 one
does not at 10^8 ranks), the entry fails a run whose predictions lie
further, a run is `correct` with the model trained on its first run and
loaded on the next, the control is not, and the NN metrics read their
numbers (by hand) or nothing; on the card (`-m cuda`) the kernel against
the reference and the cell end to end."""

import json
import os
import time

import numpy as np
import pytest
import torch

from portbench import counted, harness, nn_model, nn_reference, nn_roofline
from portbench.harness import Cell, Run
from portbench.index_cache import QUERY_SKIP, ensure_artifact
from portbench.tests.tiny import CELL, CONFIG, TINY_B, make_root, read
from portbench.trace_reader import Trace

NN_CONFIG = "tiny-genome-nn64x16"
NN_MIX = "tiny-nn-mix"
NN_CELL = f"{NN_CONFIG}.{NN_MIX}"
REAL_CELL = "celegans-100M-k21-nn64x16.nn-kmer-mix"
# the metrics of the NN cell alone, and the older ones it reports too
NEW = ("nn_predict_roofline_pct", "nn_plquery_roofline_pct",
       "nn_window_ranks")
SHARED = ("index_ready_s", "host_call_us", "device_idle_pct",
          "probes_per_query", "sectors_per_query",
          "genome_sectors_per_query", "bisect_steps_per_query",
          "lane_use_pct")


def make_nn_root(root: str) -> str:
    """tiny.make_root with the NN cell beside the tiny one: the NN
    configuration on tiny.py's genome, the NN mix at TINY_B queries, the
    NN cell's metrics of BENCHMARK.json on the NN cell (the older ones on
    the tiny cell too)."""
    make_root(root)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    config = read("portbench/configs/celegans-100M-k21-nn64x16.json")
    config.update(name=NN_CONFIG)
    config["genome"] = read_root(root, f"portbench/configs/{CONFIG}.json")[
        "genome"]
    mix = read("portbench/traffic/nn-kmer-mix.json")
    mix["queries_per_request"] = TINY_B
    for rel, obj in ((f"portbench/configs/{NN_CONFIG}.json", config),
                     (f"portbench/traffic/{NN_MIX}.json", mix)):
        with open(os.path.join(root, rel), "w") as f:
            json.dump(obj, f)
    bench["configs"].append({"name": NN_CONFIG, "source": "test",
                             "reduced": [], "why": "test",
                             "file": f"portbench/configs/{NN_CONFIG}.json"})
    bench["workloads"].append({"name": NN_CELL, "config": NN_CONFIG,
                               "traffic": NN_MIX, "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] = [NN_CELL]
        elif m["name"] in SHARED:
            m["workloads"] = [CELL, NN_CELL]
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def read_root(root, rel):
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_nn_root(str(tmp_path_factory.mktemp("nn")))


@pytest.fixture(scope="module")
def cell(root):
    return Cell.find(root, NN_CELL)


def query_index(cell, device="cpu"):
    """The cell's index as the harness loads it."""
    from sapling_tpu_torch.index.sapling import SaplingIndex

    cache = os.path.join(cell.root, "portbench", ".cache")
    artifact, _ = ensure_artifact(cell.root, cache, cell.config,
                                  cell.config_file)
    return SaplingIndex.load(artifact, skip=QUERY_SKIP, mmap=True,
                             device=device)


def run_nn(root, capsys, seed, wrap_call=None, card=False, trace=0):
    argv = ["--workload", NN_CELL, "--seed", str(seed), "--seconds", "0.3",
            "--trace", str(trace)]
    rc = harness.main(argv, time.perf_counter(), root, require_card=card,
                      wrap_call=wrap_call)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]) if rc == 0 else None, \
        err


def test_spec_is_the_configurations_model():
    """The entry's constants (nn_model.SPEC) are the configuration file's
    `model` object, the one the program trains (a spec with another
    convergence rule is not), and its mix asks for k-base queries only."""
    config = read("portbench/configs/celegans-100M-k21-nn64x16.json")
    assert nn_model.SPEC == config["model"]
    assert nn_model.trained_by(nn_model.SPEC)
    assert not nn_model.trained_by(dict(nn_model.SPEC, convergence_window=9))
    mix = read("portbench/traffic/nn-kmer-mix.json")
    assert mix["lengths"] == [config["index"]["k"]]
    bench = read("BENCHMARK.json")
    nn = [m for m in bench["per_layer"] if m["name"] in NEW]
    assert [m["name"] for m in nn] == list(NEW)
    assert all(m["workloads"] == [REAL_CELL] for m in nn)
    assert {m["name"] for m in bench["per_layer"]
            if REAL_CELL in m["workloads"]} == set(NEW + SHARED)


def rank_scale_model(n: int, seed: int):
    """A served model's fields at n ranks: 64 chunks of 16 units of seeded
    random weights, ascending float32 boundaries, and un-scaling constants
    of rank scale (the line through 0 and n, a residual spread of n/50)."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    c, s = 64, 16
    xb = np.sort(rng.random(c)).astype(np.float32)
    xb[0] = 0.0
    params = [{"w": torch.from_numpy(rng.normal(0, 2, (c, 1, s))),
               "b": torch.from_numpy(rng.normal(0, 1, (c, s)))},
              {"w": torch.from_numpy(rng.normal(0, 0.5, (c, s, 1))),
               "b": torch.from_numpy(rng.normal(0, 0.5, (c, 1)))}]
    return SimpleNamespace(params=params, xb=torch.from_numpy(xb),
                           x_max=float(4 ** 21 - 1), line_m=float(n),
                           line_c=0.0, res_ptp=n / 50.0,
                           res_min=-n / 100.0, n=n, k=21)


def program_ranks(model, x):
    """The program's prediction (NNServing.predict_ranks, the plain
    version on the CPU) of a model with these fields."""
    from sapling_tpu_torch.models.serve import NNServing

    srv = NNServing(params=model.params, xb=model.xb, x_max=model.x_max,
                    res_min=model.res_min, res_ptp=model.res_ptp,
                    line_m=model.line_m, line_c=model.line_c, n=model.n,
                    k=model.k)
    return srv.predict_ranks(x)


def test_reference_matches_the_program_within_one_rank(cell):
    """On a model trained on the tiny genome's query-time index and on
    seeded random weights at 10^8 ranks, the reference's float64 ranks
    match the program's within 1 (its sums run in another order, so a row
    on a rounding edge may round the other way). At 10^8 ranks float32's
    spacing is 8, so the same reference in float32 misses that bound on
    many k-mers: the comparison would catch a prediction computed in the
    precision below the configuration's (42% of these k-mers miss it)."""
    index = query_index(cell)
    srv = nn_model.served_model(
        index, os.path.join(cell.root, "portbench", ".cache"))
    from sapling_tpu_torch.models.serve import kmer_stream
    kmers = kmer_stream(index)[0]
    got = nn_reference.predict_ranks(srv, kmers, block=4096)
    assert (got - srv.predict_ranks(kmers)).abs().max() <= 1
    model = rank_scale_model(10 ** 8, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 4 ** 21, 50_000))
    want = program_ranks(model, x)
    assert want.max() > 5 * 10 ** 7
    assert (nn_reference.predict_ranks(model, x) - want).abs().max() <= 1
    low = (nn_reference.predict_ranks(model, x, torch.float32) - want).abs()
    assert low.max() >= 4 and (low > 1).float().mean() > 0.3


def test_nn_cell_on_the_cpu(tmp_path, capsys):
    """The NN cell through the harness on the CPU: `correct`, the model
    trained on the checkout's first run and loaded on the next, with the
    same windows."""
    root = make_nn_root(str(tmp_path))
    nn_model.SERVED.clear()
    windows = []
    for how, seed in (("trained", 4_100_000_003), ("loaded", 4_100_000_004)):
        rc, result, err = run_nn(root, capsys, seed)
        assert rc == 0, err
        assert result["correct"] is True
        assert f"nn model {how}" in err
        assert nn_model.SERVED["how"] == how
        windows.append({w: nn_model.SERVED[w] for w in nn_model.WINDOWS})
    assert windows[0] == windows[1]


def test_prediction_check(root, cell, capsys, monkeypatch):
    """The entry's check of the served predictions against the float64
    reference: at 10^8 ranks it passes the program's and fails the
    reference's own in float32 (float32's spacing there is 8); through a
    whole run on the tiny genome, where float32 hardly rounds, it passes
    the program's predictions and fails a run whose predictions lie 2
    ranks off."""
    model = rank_scale_model(10 ** 8, seed=5)
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 4 ** 21, 50_000))
    assert nn_reference.rank_gap(model, x, program_ranks(model, x))[1] == 0
    low = nn_reference.predict_ranks(model, x, torch.float32)
    largest, over = nn_reference.rank_gap(model, x, low)
    assert largest >= 4 and over > 10_000
    rc, result, err = run_nn(root, capsys, 4_100_000_006)
    assert rc == 0 and result["correct"] is True
    assert "0 more than 1 rank apart (limit 0)" in err
    from sapling_tpu_torch.models.serve import NNServing

    predict = NNServing.predict_ranks
    monkeypatch.setattr(NNServing, "predict_ranks",
                        lambda srv, x: predict(srv, x) + 2)
    with pytest.raises(RuntimeError, match="not the configuration's"):
        run_nn(root, capsys, 4_100_000_007)


def prediction_alone_call(root, cell):
    """A `wrap_call` answering each request of the NN cell with the
    position at the rank the reference's NN predicts, unrefined: a learned
    index that trusts its model and skips the search (the comparison's
    control for this cell; control.py's k-mer-only lookup checks all k
    bases of a k-base query and is exact here)."""
    index = query_index(cell)
    srv = nn_model.served_model(
        index, os.path.join(root, "portbench", ".cache"))
    rev = torch.from_numpy(np.asarray(index.rev, dtype=np.int64))

    def wrap(call):
        def wrapped(index, inputs, length):
            return rev[nn_reference.predict_ranks(srv, inputs[0])]
        return wrapped
    return wrap


def test_control_is_not_correct(root, cell, capsys):
    """The prediction alone, in the program's place through a whole run,
    comes out not correct."""
    rc, result, _ = run_nn(root, capsys, 4_100_000_005,
                           wrap_call=prediction_alone_call(root, cell))
    assert rc == 0
    assert result["correct"] is False
    assert result["checks"]["wrong_answers"]["value"] > 0


def trace_of(kernels, window=(0.0, 1e-3)):
    return Trace(window=window, device_ops=kernels,
                 host_ops=[("portbench.wait", *window)])


def test_roofline_counts_by_hand():
    """93 fp64 operations a query at 16 units, bound by them (not by 16
    bytes) at the H100's fp64 rate; the plquery bytes of three 21-mers:
    two words, the k-mer, the prediction and the position, 40 a query."""
    assert nn_roofline.predict_ops(3, 16) == 3 * 93
    rate = 132 * 64 * 1.98e9
    assert nn_roofline.predict_seconds(10 ** 6, 16) == pytest.approx(
        93e6 / rate)
    assert 93e6 / rate > 16e6 / 3.35e12
    assert nn_roofline.predict_seconds(10, 1) == pytest.approx(
        max(18 * 10 / rate, 160 / 3.35e12))
    rows = np.zeros((3, 21), dtype=np.uint8)
    assert nn_roofline.plquery_bytes(rows) == 3 * 40


def test_readers_by_hand(cell):
    """Each reader's number from a known run: the kernels' shares of their
    bounds from the traced batches and the kernels' seconds (two launches
    of half the time read as one), the window from the served model, the
    bisection steps (the older reader, on the NN cell) from planted
    counts; nothing without a trace, a kernel, a served model or
    counts."""
    rng = np.random.default_rng(2)
    batches = {21: rng.integers(0, 4, (1000, 21), dtype=np.uint8)}
    traced = [21, 21, 21]
    readers = {name: cell.module("metrics", name) for name in NEW}

    def run_with(kernels):
        return Run(cell=cell, k=21, buckets=10, batches=batches,
                   traced=traced, trace=trace_of(kernels))

    nn = run_with([("void nn_predict_kernel<true, 16>(NNArgs)", 0, 2e-4),
                   ("void plquery_kernel<1, int, true>(Args)", 2e-4, 6e-4)])
    split = run_with([("nn_predict_kernel", 0, 1e-4),
                      ("nn_predict_kernel", 5e-4, 6e-4),
                      ("plquery_kernel", 1e-4, 3e-4),
                      ("plquery_kernel", 6e-4, 8e-4)])
    predict = readers["nn_predict_roofline_pct"]
    want = 100 * nn_roofline.predict_seconds(3000, 16) / 2e-4
    assert predict.read(nn) == pytest.approx(want)
    assert predict.read(split) == pytest.approx(want)
    plq = readers["nn_plquery_roofline_pct"]
    want = 100 * 3 * nn_roofline.plquery_bytes(batches[21]) / 3.35e12 / 4e-4
    assert plq.read(nn) == pytest.approx(want)
    assert plq.read(split) == pytest.approx(want)
    for name in ("nn_predict_roofline_pct", "nn_plquery_roofline_pct"):
        assert readers[name].read(run_with([("binsearch_kernel", 0, 1e-4)])
                                  ) is None
        assert readers[name].read(Run(cell=cell, k=21, buckets=10,
                                      batches=batches)) is None
    window = readers["nn_window_ranks"]
    saved = dict(nn_model.SERVED)
    try:
        nn_model.SERVED.clear()
        assert window.read(nn) is None
        nn_model.SERVED.update(max_over=30, max_under=12, most_over=3,
                               most_under=2)
        assert window.read(nn) == 42
    finally:
        nn_model.SERVED.clear()
        nn_model.SERVED.update(saved)
    steps = cell.module("metrics", "bisect_steps_per_query")
    planted = Run(cell=cell, k=21, buckets=10, batches=batches)
    planted.counts = {21: {"d_steps": np.array([20, 22, 24, 26], np.int32)}}
    assert steps.read(planted) == 23.0
    planted.counts = None
    assert steps.read(planted) is None
    cell.module("entries", "nn_engine")
    assert counted.STATS_CALLS.get("nn_engine") is not None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_kernel_matches_the_reference_on_the_card(card, cell):
    """The kernel's ranks (NNServing.predict_ranks on the card) of every
    k-mer of the tiny genome and of a batch of the mix match the plain
    reference's within 1; every present query's rank run meets the window
    [pred - max_under, pred + max_over] of the reference's prediction."""
    index = query_index(cell, "cuda")
    srv = nn_model.served_model(
        index, os.path.join(cell.root, "portbench", ".cache"))
    from sapling_tpu_torch.models.serve import kmer_stream
    kmers = kmer_stream(index)[0]
    assert (nn_reference.predict_ranks(srv, kmers)
            - srv.predict_ranks(kmers)).abs().max() <= 1
    assert (nn_reference.predict_ranks(srv, kmers.cpu())
            - srv.predict_ranks(kmers).cpu()).abs().max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_nn_cell_on_the_card(card, tmp_path, capsys, trace):
    """The NN cell end to end on the card: `correct`, and with a trace
    every metric BENCHMARK.json gives the cell, the shares inside
    (0, 100]."""
    root = make_nn_root(str(tmp_path))
    rc, result, err = run_nn(root, capsys, 4_300_000_011, card=True,
                             trace=trace)
    assert rc == 0, err
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert set(NEW + SHARED) <= set(result["metrics"])
        for name in NEW[:2]:
            assert 0 < result["metrics"][name]["value"] <= 100


def test_nn_check_on_the_cpu(root, cell, capsys):
    """portbench/nn_check.py at the tiny size on the CPU (--device cpu):
    the reference matches the program's ranks within 1, no present query
    falls outside its window, the program's answers are right and the
    prediction alone is wrong; two more trainings give the served model's
    parameters and windows."""
    from portbench import nn_check

    query_index(cell)
    assert nn_check.main(["--workload", NN_CELL, "--seeds", "7",
                          "--retrain", "1", "--device", "cpu"], root) == 0
    lines = [json.loads(line)
             for line in capsys.readouterr().out.strip().splitlines()]
    seed, trainings = lines
    assert seed["kernel_vs_reference"]["float64_over_1"] == 0
    assert seed["present"] > 0 and seed["outside_window"] == 0
    assert seed["program"]["missed"] == seed["program"]["out_of_range"] == 0
    assert seed["float32_engine"]["out_of_range"] == 0
    assert seed["prediction_alone"]["missed"] > seed["present"] // 2
    assert all(t["params_equal"] and t["windows_equal"]
               for t in trainings["retrained"])
