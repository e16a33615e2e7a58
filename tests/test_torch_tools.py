"""The port's CLI twins of tools/sapling_example.py,
tools/binarysearch.py, tools/bench_query_scale.py, tools/bench_align.py,
tools/bench_align_ab.py, tools/bench_sweep.py and tools/query_big_split.py
run on the CPU and self-check every answer (query_big_split's as JAX's
tool does); the sapling_example twin's sapFn/errFn dumps and the
ref_to_suffix_array twin's .ref/.sa bytes equal the JAX package's; the
microbench_gather twin runs every mode and gen_perf_table rewrites its
README block; the TPU-only flags of bench_query_scale, bench_align's
ref=1 and bench_align_ab's seedcu are refused.
"""

import json
import re

import numpy as np
import pytest

from sapling_tpu.config import IndexConfig as JaxIndexConfig
from sapling_tpu.index.pwl import error_audit
from sapling_tpu.index.sapling import SaplingIndex as JaxIndex
from sapling_tpu.io import artifacts
from sapling_tpu.ops.pack import kmers_scan
from sapling_tpu.ops.predict import predict_pwl_f64
from sapling_tpu_torch.io.fasta import write_fasta
from sapling_tpu_torch.sim.genomes import benchmark_genome
from sapling_tpu_torch.tools import (bench_align, bench_align_ab,
                                     bench_query_scale, bench_sweep,
                                     binarysearch, build_big_index,
                                     gen_perf_table, microbench_gather,
                                     query_big_split, ref_to_suffix_array,
                                     retable_index, sapling_example)

_CORRECT = re.compile(r"correctness: (\d+) out of (\d+)")
_SELF_CHECK = re.compile(r"self-check (\d+)/(\d+)")


@pytest.fixture
def fasta(tmp_path):
    path = str(tmp_path / "toy.fa")
    write_fasta(path, [("toy", bytes(benchmark_genome(20_000, seed=5)))])
    return path


def _all_correct(out: str, lines: int, nq: int):
    found = _CORRECT.findall(out)
    assert len(found) == lines, out
    assert all(int(a) == int(b) == nq for a, b in found), out


def test_sapling_example_sweep(fasta, tmp_path, capsys):
    sap, err = str(tmp_path / "toy.sap"), str(tmp_path / "toy.errors")
    argv = ["sapling_example", fasta, "k=12", "nb=8", "nq=300", "batch=128",
            f"sapFn={sap}", f"errFn={err}", "device=cpu"]
    assert sapling_example.main(argv) == 0
    # six lengths k-10 ... k+80, each plQuery and binary search
    _all_correct(capsys.readouterr().out, 12, 300)

    jidx = JaxIndex.from_fasta(fasta, JaxIndexConfig(k=12, buckets=8))
    jsap = str(tmp_path / "jax.sap")
    jidx.write_reference_artifacts(None, jsap)
    inv64, lcp64 = artifacts.read_sa(fasta + ".sa")
    kmers = kmers_scan(jidx.codes, 12)
    t = jidx.table
    audit = error_audit(kmers, inv64, lcp64, t.xlist, t.ylist, 12, 8, jidx.n)
    pred = predict_pwl_f64(kmers, t.xlist, t.ylist, 24, 8, jidx.n)
    jerr = str(tmp_path / "jax.errors")
    artifacts.write_errors_text(jerr, kmers, inv64[: kmers.shape[0]], pred,
                                audit.errors, 8)
    for ours, theirs in ((sap, jsap), (err, jerr)):
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), ours


@pytest.mark.parametrize("fancy", [0, 1])
def test_binarysearch(fasta, capsys, fancy):
    argv = ["binarysearch", fasta, "nq=400", "qLen=13", "batch=150",
            f"fancy={fancy}", "device=cpu"]
    assert binarysearch.main(argv) == 0
    _all_correct(capsys.readouterr().out, 1, 400)


def test_predict_pwl_f64_matches_jax():
    from sapling_tpu_torch.ops.predict import predict_pwl_f64 as ours

    rng = np.random.default_rng(1)
    xlist = np.sort(rng.integers(0, 1 << 24, 65)).astype(np.int64)
    xlist[10] = xlist[11]                       # a degenerate bucket
    ylist = np.sort(rng.integers(0, 10_000, 65)).astype(np.int64)
    x = rng.integers(0, 1 << 24, 5000).astype(np.int64)
    with np.errstate(invalid="ignore"):     # 0/0 in the degenerate bucket
        np.testing.assert_array_equal(
            ours(x, xlist, ylist, 24, 6, 10_000),
            predict_pwl_f64(x, xlist, ylist, 24, 6, 10_000))


@pytest.fixture(scope="module")
def artifacts_dir(tmp_path_factory):
    """A k=21 query artifact with bounds and its 2^9 retable, and a k=16
    aligner artifact, from the port's build_big_index."""
    d = tmp_path_factory.mktemp("scale")
    common = ["stage=0", "workers=1"]
    assert build_big_index.main(
        ["b", "n=200000", "k=21", "nb=10", "bounds=1", *common,
         f"out={d / 'q.stpu.npz'}"]) == 0
    assert retable_index.main(
        ["r", str(d / "q.stpu.npz"), "nb=9", "workers=1",
         f"out={d / 'q_nb9.table.npz'}"]) == 0
    assert build_big_index.main(
        ["b", "n=200000", "k=16", "nb=10", "aligner=1", *common,
         f"out={d / 'a.stpu.npz'}"]) == 0
    return d


@pytest.mark.parametrize("ab", [True, False])
def test_bench_query_scale(artifacts_dir, capsys, ab):
    """ab=1: the artifact's table, then its 2^9 retable (which has no
    bounds); else adaptive=1 on the artifact's own bounds."""
    d = artifacts_dir
    extra = ([f"table={d / 'q_nb9.table.npz'}", "ab=1"] if ab
             else ["adaptive=1"])
    argv = ["bqs", str(d / "q.stpu.npz"), "nq=3000", "qLen=21,41",
            "iters=1", "hitrate=1", *extra, "device=cpu"]
    assert bench_query_scale.main(argv) == 0
    out = capsys.readouterr().out
    found = _SELF_CHECK.findall(out)
    assert len(found) == (4 if ab else 2), out
    assert all(a == b == "3000" for a, b in found), out
    assert "prediction-probe hit rate" in out and "index on cpu" in out


@pytest.mark.parametrize("flag", bench_query_scale.TPU_ONLY)
def test_bench_query_scale_refuses_tpu_flags(artifacts_dir, flag):
    with pytest.raises(SystemExit) as e:
        bench_query_scale.main(["bqs", str(artifacts_dir / "q.stpu.npz"),
                                f"{flag}=1", "device=cpu"])
    assert f"{flag}=" in str(e.value.code) and "TPU" in str(e.value.code)


def test_bench_align(artifacts_dir, capsys):
    argv = ["ba", "n=200000", "reads=200", "block=128", "workers=2",
            f"index={artifacts_dir / 'a.stpu.npz'}", "device=cpu"]
    assert bench_align.main(argv) == 0
    out = capsys.readouterr().out
    m = re.search(r"aligned: (\d+)/200; within 10bp of truth: (\d+)", out)
    assert m and int(m[1]) >= 190 and int(m[2]) >= 150, out
    with pytest.raises(SystemExit) as e:
        bench_align.main(["ba", "ref=1", "device=cpu"])
    assert "ref=1" in str(e.value.code)


def _without_matplotlib(monkeypatch):
    """Imports of matplotlib fail, as on the card's machine."""
    import sys

    import sapling_tpu_torch.evalx as evalx

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "sapling_tpu_torch.evalx.plots",
                        raising=False)
    monkeypatch.delattr(evalx, "plots", raising=False)


def _bench_sweep(tmp_path, capsys):
    """The twin at a tiny size: results.json and the printed self-checks;
    returns the PNGs written and the last line printed."""
    argv = ["bs", "sizes=100000,150000", "nq=3000", f"cache={tmp_path}",
            f"out={tmp_path / 'out'}", "device=cpu"]
    assert bench_sweep.main(argv) == 0
    with open(tmp_path / "out" / "results.json") as f:
        res = json.load(f)
    assert [r["n"] for r in res["sizes"]] == [100_000, 150_000]
    assert all(r["binsearch_qps"] > 0 and r["device_bytes"] > 0
               for r in res["sizes"])
    points = res["qlen_sweep"]["points"]
    assert [p["qlen"] for p in points] == list(bench_sweep.SWEEP)
    for p in res["sizes"] + [p for p in points if p["qlen"] >= 21]:
        good, total = p["self_check"].split("/")
        assert good == total, p
    out = capsys.readouterr().out
    assert "self_check" in out
    return ({p.name for p in (tmp_path / "out").glob("*.png")},
            out.strip().splitlines()[-1])


def test_bench_sweep(tmp_path, capsys):
    """results.json, then the JAX tool's three plots where matplotlib is
    installed."""
    pngs, last = _bench_sweep(tmp_path, capsys)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert not pngs and "matplotlib is not installed" in last, last
    else:
        assert pngs == {"timing.png", "memory.png", "query_length.png"}
        assert last.endswith("+ plots"), last


def test_bench_sweep_without_matplotlib(tmp_path, capsys, monkeypatch):
    """Without matplotlib the last line says so, no plot is written and
    the tool still succeeds."""
    _without_matplotlib(monkeypatch)
    pngs, last = _bench_sweep(tmp_path, capsys)
    assert not pngs and "matplotlib is not installed" in last, last


def test_query_big_split(tmp_path, capsys):
    """The twin on a small split-limb artifact from the port's build_split,
    force_small=1, idx=2 x dp=2 gloo ranks on the CPU: every check passes,
    and its self-check and hi-limb counts are JAX's tool's on the same
    artifact (4 of conftest's virtual devices)."""
    import os
    import sys

    art = str(tmp_path / "split.stpu.npz")
    build_big_index.build_split(100_000, 16, 8, workers=1, out=art)
    capsys.readouterr()
    args = [art, "nq=3000", "idx=2", "dp=2", "force_small=1"]
    assert query_big_split.main(["qbs", *args, "device=cpu",
                                 "backend=gloo"]) == 0
    ours = capsys.readouterr().out
    assert "4 ranks (gloo, cpu)" in ours
    assert "mesh: {'dp': 2, 'idx': 2}" in ours
    assert "self-check: 3000/3000" in ours, ours
    assert "sharded == single-device: exact" in ours, ours
    assert re.search(r"device bytes a rank at idx=2: .* sharded rev "
                     r"250,000 ", ours), ours

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import query_big_split as jax_tool

    assert jax_tool.main(["qbs", *args]) == 0
    theirs = capsys.readouterr().out
    for key in ("self-check: ", "positions with hi limb nonzero: "):
        line = [ln for ln in ours.splitlines() if ln.startswith(key)]
        assert line and line[0] in theirs.splitlines(), (line, theirs)


def test_bench_align_ab(artifacts_dir, capsys):
    argv = ["bab", "n=200000", "reads=200", "repeats=1",
            "configs=base,block32k,coalesce4",
            f"index={artifacts_dir / 'a.stpu.npz'}", "device=cpu"]
    assert bench_align_ab.main(argv) == 0
    out = capsys.readouterr().out
    for name in ("base", "block32k", "coalesce4"):
        m = re.search(rf"\[{name}\] [\d,.]+ reads/s on cpu \(median of 1: "
                      r".*; (\d+) aligned, (\d+) within 10bp\)", out)
        assert m and int(m[1]) >= 190 and int(m[2]) >= 150, out
    assert out.strip().splitlines()[-1].startswith("A/B: base:")
    for bad in ("seedcu", "base,nope"):
        with pytest.raises(SystemExit):
            bench_align_ab.main(["bab", f"configs={bad}", "device=cpu"])


def test_ref_to_suffix_array_matches_jax(fasta, tmp_path, capsys):
    """The .ref and .sa bytes equal the JAX tool's; existing outputs are
    skipped."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import ref_to_suffix_array as jax_tool

    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert ref_to_suffix_array.main(["r2sa", fasta, ours]) == 0
    assert jax_tool.main(["r2sa", fasta, theirs]) == 0
    for ext in (".ref", ".sa"):
        with open(ours + ext, "rb") as a, open(theirs + ext, "rb") as b:
            assert a.read() == b.read(), ext
    capsys.readouterr()
    with open(ours + ".ref", "wb") as f:
        f.write(b"kept")
    assert ref_to_suffix_array.main(["r2sa", fasta, ours]) == 0
    out = capsys.readouterr().out
    assert f"skip {ours}.ref (exists)" in out
    assert f"skip {ours}.sa (exists)" in out
    with open(ours + ".ref", "rb") as f:
        assert f.read() == b"kept"


def test_microbench_gather(capsys):
    """Every mode at a tiny size on the CPU: one line each, the chains'
    indexes kept inside their operands."""
    argv = ["mg", "n=300000", "lanes=2000", "iters=3", "gb=0.001,0.002",
            "device=cpu"]
    assert microbench_gather.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    names = [ln.split()[0] for ln in lines]
    assert names == ["halves", "rev2d", "words32", "words64", "argsort64",
                     "argsort32", "rand", "sort", "rand", "sort"], lines
    assert all("M lanes/s" in ln for ln in lines)
    assert sum("GB/s of 32-byte sectors" in ln for ln in lines) == 8
    with pytest.raises(SystemExit):
        microbench_gather.main(["mg", "which=halves,flat", "device=cpu"])


def test_gen_perf_table(tmp_path, capsys):
    """A copy of README.md: the perf-torch block is rewritten from
    docs/measured_torch.json, the TPU block and the rest stay."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "README.md")) as f:
        src = f.read()
    data_path = os.path.join(root, "docs", "measured_torch.json")
    with open(data_path) as f:
        data = json.load(f)
    begin, end = "<!-- perf-torch:begin -->\n", "<!-- perf-torch:end -->"
    head, rest = src.split(begin)
    _old, tail = rest.split(end)
    readme = tmp_path / "README.md"
    readme.write_text(head + begin + "stale\n" + end + tail)
    argv = ["gpt", f"readme={readme}", f"data={data_path}"]
    assert gen_perf_table.main(argv) == 0
    got = readme.read_text()
    assert got == head + begin + gen_perf_table.table(data) + "\n" + end \
        + tail
    assert got == src              # README.md holds the generated block
    block = gen_perf_table.table(data)
    assert data["measured_on"] in block and "NVIDIA H100" in block
    for row in data["scales"]:
        assert row["label"] in block
    readme.write_text("no markers\n")
    with pytest.raises(SystemExit):
        gen_perf_table.main(argv)
