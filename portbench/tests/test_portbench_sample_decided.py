"""sample_decided_per_query's reader on planted counts: the mean of the
kernels' sample_decided row over each length's batch, the lengths
weighted equally; nothing where the program writes no such row (a kernel
without the rank sample's counter) or the run has no counts."""

import numpy as np
import pytest

from portbench.harness import Cell, Run, per_layer
from portbench.tests.tiny import CELL, make_root

NAME = "sample_decided_per_query"


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return Cell.find(make_root(str(tmp_path_factory.mktemp("sample"))), CELL)


def planted(cell, counts):
    run = Run(cell=cell, k=21, buckets=18, batches={})
    run.counts = counts
    return run


def test_reader_on_planted_counts(cell):
    """Two lengths of unequal batches: (0 + 2 + 4 + 6) / 4 at L=21 and 13
    at L=31 weigh equally; the reader is the metric the line reports."""
    counts = {21: {"probes": np.full(4, 20, np.int32),
                   "sample_decided": np.array([0, 2, 4, 6], np.int32)},
              31: {"probes": np.full(2, 20, np.int32),
                   "sample_decided": np.array([13, 13], np.int32)}}
    run = planted(cell, counts)
    reader = cell.module("metrics", NAME)
    assert reader.read(run) == pytest.approx((3 + 13) / 2)
    assert per_layer(cell, run)[NAME]["value"] == pytest.approx(8.0)
    assert per_layer(cell, run)[NAME]["unit"] == "probes"


def test_reader_silent_without_the_row(cell):
    """An older program (no sample_decided row), a run without counts and
    an empty slice: no value, and the line leaves the metric out while it
    reports the rows the program wrote."""
    reader = cell.module("metrics", NAME)
    older = planted(cell, {21: {"probes": np.array([2, 3], np.int32)}})
    assert reader.read(older) is None
    assert NAME not in per_layer(cell, older)
    assert per_layer(cell, older)["probes_per_query"]["value"] == 2.5
    for counts in (None, {}):
        assert reader.read(planted(cell, counts)) is None
    mixed = planted(cell, {21: {"sample_decided": np.array([1], np.int32)},
                           31: {"probes": np.array([1], np.int32)}})
    assert reader.read(mixed) is None
