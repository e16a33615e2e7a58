"""The port's evalx/ == sapling_tpu's, on tests/test_evalx.py's inputs:
the k-mer spectrum, the per-bucket error statistics and extremes, a
bucket's scatter, the SAM-vs-truth quality and the truth records; and
evalx/plots.py writes its six PNGs."""

import numpy as np
import pytest

from sapling_tpu.evalx import alignment_quality as jaq
from sapling_tpu.evalx import bins as jbins
from sapling_tpu.evalx import kmer_stats as jks
from sapling_tpu.index.pwl import build_pwl as jax_build_pwl
from sapling_tpu_torch.evalx import alignment_quality, bins, kmer_stats
from sapling_tpu_torch.index.pwl import build_pwl
from sapling_tpu_torch.index.suffix_array import build_suffix_data
from sapling_tpu_torch.ops.pack import encode_bases
from sapling_tpu_torch.sim.genomes import repeat_genome, uniform_genome


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_kmer_spectrum_matches_jax():
    g = np.concatenate([uniform_genome(800, seed=3),
                        repeat_genome(200, 7, seed=4)])
    sd = build_suffix_data(g)
    for max_k in (12, 1200):            # past n: the clamped tail
        _equal(kmer_stats.kmer_spectrum(sd.lcp, g.shape[0], max_k=max_k),
               jks.kmer_spectrum(sd.lcp, g.shape[0], max_k=max_k))


@pytest.fixture(scope="module")
def audited():
    g = uniform_genome(20_000, seed=6)
    sd = build_suffix_data(g)
    codes = encode_bases(g)
    _t, audit, kmers = build_pwl(codes, sd.inv, sd.lcp, 21, 8,
                                 return_audit=True)
    _jt, jaudit, jkmers = jax_build_pwl(codes, sd.inv, sd.lcp, 21, 8,
                                        return_audit=True)
    np.testing.assert_array_equal(audit.errors, jaudit.errors)
    return sd, audit, kmers, jaudit, jkmers


def test_per_bin_errors_and_extremes_match_jax(audited):
    sd, audit, kmers, jaudit, jkmers = audited
    _equal(bins.per_bin_errors(audit, kmers, 21, 8),
           jbins.per_bin_errors(jaudit, jkmers, 21, 8))
    for by in ("max", "mean", "median"):
        got = bins.best_and_worst_bins(audit, kmers, 21, 8, count=3, by=by)
        want = jbins.best_and_worst_bins(jaudit, jkmers, 21, 8, count=3,
                                         by=by)
        assert (got["best"], got["worst"]) == (want["best"], want["worst"])
        _equal(got["stats"], want["stats"])
    worst = got["worst"][0]
    ranks = sd.inv[:kmers.shape[0]]
    for a, b in zip(bins.bin_scatter(kmers, ranks, 21, 8, worst),
                    jbins.bin_scatter(jkmers, ranks, 21, 8, worst)):
        np.testing.assert_array_equal(a, b)


def test_alignment_quality_matches_jax(tmp_path):
    names, chroms = ["r1", "r2", "r3", "r4"], ["c"] * 4
    truth = alignment_quality.truth_sam_lines(names, chroms,
                                              [100, 200, 300, 400],
                                              flags=[0, 16, 0, 0])
    assert truth == jaq.truth_sam_lines(names, chroms, [100, 200, 300, 400],
                                        flags=[0, 16, 0, 0])
    got = ["@HD\tVN:1.0",
           "r1\t0\tc\t105\t60\t*\t*\t0\t0\t*\t*",   # within 10 -> good
           "r2\t0\tc\t250\t60\t*\t*\t0\t0\t*\t*",   # off by 49 -> bad
           "r3\t4\t*\t0\t255\t*\t*\t0\t0\t*\t*"]    # unaligned; r4 missing
    sam = tmp_path / "got.sam"
    sam.write_text("\n".join(got) + "\n")
    for produced in (got, str(sam)):
        rep = alignment_quality.compare_sam(produced, truth)
        jrep = jaq.compare_sam(produced, truth)
        assert (rep.good, rep.bad, rep.unaligned, rep.missing, rep.total) \
            == (jrep.good, jrep.bad, jrep.unaligned, jrep.missing,
                jrep.total) == (1, 1, 1, 1, 4)


def test_plots_write_six_pngs(tmp_path, audited):
    pytest.importorskip("matplotlib")
    from sapling_tpu_torch.evalx import plots

    sd, audit, kmers, _ja, _jk = audited
    ranks = sd.inv[:kmers.shape[0]]
    xl = np.linspace(0, 1 << 42, 257).astype(np.int64)
    yl = np.linspace(0, len(ranks), 257).astype(np.int64)
    d = str(tmp_path)
    paths = [
        plots.timing_plot([4.6e6, 4.6e7], {"port": [1e8, 5e7]},
                          f"{d}/timing.png"),
        plots.query_length_plot([11, 21], {"port": [2e8, 1e8]},
                                f"{d}/length.png"),
        plots.memory_plot(["4.6Mbp", "46Mbp"], [0.1, 1.0],
                          f"{d}/memory.png"),
        plots.sa_shape_plot(kmers[::50], ranks[::50], f"{d}/sa.png"),
        plots.error_histogram_plot(audit.errors, f"{d}/errors.png"),
        plots.bin_scatter_plot(kmers[:100], ranks[:100], xl, yl, 3, 21, 8,
                               f"{d}/bin.png"),
    ]
    assert len(set(paths)) == 6
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p
