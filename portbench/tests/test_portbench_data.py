"""The frozen genome and the traffic generator reproduce their seeds."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from portbench.genome import cached_genome, codes_of, make_genome
from portbench.reference import KeyTable
from portbench.tests.tiny import REPO
from portbench.traffic import LookupTraffic

with open(os.path.join(REPO, "portbench/configs/ecoli-4.6M-k21.json")) as f:
    SPEC = json.load(f)["genome"]
with open(os.path.join(REPO, "portbench/traffic/lookup-mix.json")) as f:
    MIX = json.load(f)
# sha256 of make_genome(SPEC at 100,000 bases): the frozen bytes
DIGEST_100K = "8a7f5b6fe2a3c816a29e3ec0b655704500fd12d0d66689bc479c34ba77f54a72"
BIG_SEED = 2**31 + 12345


def test_genome_is_frozen():
    g = make_genome(dict(SPEC, length=100_000))
    assert hashlib.sha256(g.tobytes()).hexdigest() == DIGEST_100K
    assert set(np.unique(g).tolist()) == set(b"ACGT")


# the parameters of the program's benchmark_genome, which the copy froze
PROGRAMS = {"seed": 20260816, "base_probabilities": [0.2, 0.3, 0.3, 0.2],
            "duplication_share": 0.10, "duplication_bases": [2000, 20000],
            "tandem_share": 0.05, "tandem_unit_bases": [2, 63],
            "tandem_copies": [5, 49]}


def test_genome_is_the_programs_benchmark_genome():
    """The copy gives the bytes of the generator it was copied from."""
    from sapling_tpu_torch.sim.genomes import benchmark_genome
    n = 300_000
    assert np.array_equal(make_genome(dict(PROGRAMS, length=n)),
                          benchmark_genome(n, seed=PROGRAMS["seed"]))


@pytest.mark.parametrize("name, gc", [("ecoli-4.6M-k21", 0.508),
                                      ("celegans-100M-k21", 0.354)])
def test_genome_has_its_organisms_gc(name, gc):
    with open(os.path.join(REPO, f"portbench/configs/{name}.json")) as f:
        spec = json.load(f)["genome"]
    g = make_genome(dict(spec, length=400_000))
    share = float(np.isin(g, np.frombuffer(b"CG", np.uint8)).mean())
    assert abs(share - gc) < 0.01


def test_cached_genome(tmp_path):
    spec = dict(SPEC, length=50_000)
    a = cached_genome(spec, str(tmp_path))
    b = cached_genome(spec, str(tmp_path))
    assert np.array_equal(a, make_genome(spec)) and np.array_equal(a, b)
    assert len(os.listdir(tmp_path)) == 1


@pytest.fixture(scope="module")
def genome():
    return codes_of(make_genome(dict(SPEC, length=200_000)))


def small_mix(**kw):
    return dict(MIX, queries_per_request=4_000, **kw)


def test_batches_reproduce_their_seed(genome):
    a, b, c = (LookupTraffic(small_mix(), s) for s in (BIG_SEED, BIG_SEED,
                                                       BIG_SEED + 1))
    for length in MIX["lengths"]:
        x = a.batch(genome, length)
        assert x.shape == (4_000, length) and x.dtype == np.uint8
        assert np.array_equal(x, b.batch(genome, length))
        assert not np.array_equal(x, c.batch(genome, length))


def test_batches_hold_the_mix(genome):
    """7/8 genome substrings, shuffled among 1/8 random rows."""
    rows = LookupTraffic(small_mix(), 9).batch(genome, 41)
    occurs = KeyTable(torch.from_numpy(genome)).occurs(
        torch.from_numpy(rows)).numpy()
    assert occurs.sum() == 3_500
    assert occurs[:500].sum() < 500 and occurs[-500:].sum() < 500


def test_schedule(genome):
    t = LookupTraffic(small_mix(), BIG_SEED)
    lengths = MIX["lengths"]
    first = [next(s) for s in [t.schedule()] for _ in range(10 * 5)]
    again = [next(s) for s in [t.schedule()] for _ in range(10 * 5)]
    assert first == again
    for i in range(0, 50, 5):
        assert sorted(first[i:i + 5]) == sorted(lengths)
    other = [next(s) for s in [LookupTraffic(small_mix(), 8).schedule()]
             for _ in range(50)]
    assert other != first
    assert t.lengths == lengths
