"""The plain reference against a brute-force substring search, and the
comparison's counts."""

import numpy as np
import pytest
import torch

from portbench.genome import codes_of, make_genome
from portbench.reference import KeyTable, judge, kmer_only_answers
from portbench.traffic import lookup_batch

LENGTHS = (21, 31, 41, 51, 101)
# a genome small enough to search by brute force, with repeats
SPEC = {"length": 6_000, "seed": 5, "base_probabilities": [0.2, 0.3, 0.3, 0.2],
        "duplication_share": 0.1, "duplication_bases": [100, 400],
        "tandem_share": 0.05, "tandem_unit_bases": [2, 9],
        "tandem_copies": [5, 20]}


@pytest.fixture(scope="module")
def genome():
    return codes_of(make_genome(SPEC))


def queries(genome, length, seed):
    """Genome substrings and random rows, plus the substrings that start
    in the last 40 positions (past the key table's last key)."""
    rng = np.random.default_rng(seed)
    rows = lookup_batch(genome, length, 600, 0.5, rng)
    n = genome.shape[0]
    tail = np.stack([genome[p:p + length]
                     for p in range(n - length - 40, n - length + 1)])
    return np.concatenate([rows, tail])


def brute(genome, rows):
    """(occurs, first position or -1) by bytes.find."""
    text = genome.tobytes()
    first = np.array([text.find(r.tobytes()) for r in rows])
    return first >= 0, first


@pytest.mark.parametrize("length", LENGTHS + (5, 12))
def test_occurs_matches_brute_force(genome, length):
    rows = queries(genome, length, length)
    want, _ = brute(genome, rows)
    assert want.any() and not want.all()
    table = KeyTable(torch.from_numpy(genome))
    got = table.occurs(torch.from_numpy(rows)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("length", LENGTHS)
def test_judge_counts(genome, length):
    rows = queries(genome, length, 100 + length)
    present, first = brute(genome, rows)
    table = KeyTable(torch.from_numpy(genome))
    r = torch.from_numpy(rows)
    right = torch.from_numpy(first)
    got = judge(table, r, right)
    assert got["missed"] == 0 and got["out_of_range"] == 0
    assert got["absent"] == int((~present).sum())
    assert got["absent_unanswered"] == got["absent"]
    # an absent query answered with a position is Sapling's answer too
    unverified = right.clone()
    unverified[torch.from_numpy(~present)] = 7
    assert judge(table, r, unverified)["missed"] == 0
    # a present query answered -1, or one position off, is missed
    hit = np.flatnonzero(present)[:5]
    wrong = right.clone()
    wrong[hit[:2]] = -1
    wrong[hit[2:]] += 1
    shifted = [i for i in hit[2:]
               if not np.array_equal(genome[first[i] + 1:
                                            first[i] + 1 + length],
                                     rows[i])]
    assert judge(table, r, wrong)["missed"] == 2 + len(shifted)
    # an answer outside the genome is wrong for an absent query too
    gone = np.flatnonzero(~present)[:2]
    bad = right.clone()
    bad[gone[0]], bad[gone[1]] = -2, genome.shape[0]
    got = judge(table, r, bad)
    assert got["out_of_range"] == 2 and got["missed"] == 0
    bad[hit[0]] = -3
    assert judge(table, r, bad)["missed"] == 1


def test_any_occurrence_is_right(genome):
    """Every position that holds the query is a right answer, not only
    the first."""
    text = genome.tobytes()
    length = 21
    pos = np.arange(0, genome.shape[0] - length)
    rows = np.stack([genome[p:p + length] for p in pos])
    last = np.array([text.rfind(r.tobytes()) for r in rows])
    table = KeyTable(torch.from_numpy(genome))
    got = judge(table, torch.from_numpy(rows), torch.from_numpy(last))
    assert got["missed"] == 0
    assert (last != pos).any()


def test_kmer_only_answers_check_k_bases(genome):
    rows = queries(genome, 41, 7)
    table = KeyTable(torch.from_numpy(genome), 21)
    got = kmer_only_answers(table, torch.from_numpy(rows)).numpy()
    text = genome.tobytes()
    want = np.array([text.find(r[:21].tobytes()) for r in rows])
    assert np.array_equal(got, want)
