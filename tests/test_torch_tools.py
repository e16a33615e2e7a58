"""The port's CLI twins of tools/sapling_example.py and
tools/binarysearch.py run on the CPU and self-check every answer; the
sapling_example twin's sapFn/errFn dumps equal the JAX package's."""

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
from sapling_tpu_torch.tools import binarysearch, sapling_example

_CORRECT = re.compile(r"correctness: (\d+) out of (\d+)")


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
