"""The comparison's control at a test size: the reference's lookup that
checks only the first k bases comes out not correct on every seed."""

import pytest
import torch

from portbench.genome import codes_of, make_genome
from portbench.reference import KeyTable, judge, kmer_only_answers
from portbench.tests.tiny import read
from portbench.traffic import LookupTraffic

CONFIG = read("portbench/configs/ecoli-4.6M-k21.json")
MIX = read("portbench/traffic/lookup-mix.json")


@pytest.fixture(scope="module")
def tables():
    g = codes_of(make_genome(dict(CONFIG["genome"], length=400_000)))
    t = torch.from_numpy(g)
    return g, KeyTable(t), KeyTable(t, CONFIG["index"]["k"])


@pytest.mark.parametrize("seed", [4_200_000_001, 4_200_000_002,
                                  4_200_000_003])
def test_kmer_only_control_is_not_correct(tables, seed):
    genome, table, kmer_table = tables
    traffic = LookupTraffic(dict(MIX, queries_per_request=50_000), seed)
    missed = 0
    for length in traffic.lengths:
        rows = torch.from_numpy(traffic.batch(genome, length))
        got = judge(table, rows, kmer_only_answers(kmer_table, rows))
        assert got["out_of_range"] == 0
        missed += got["missed"]
    assert missed > 0
