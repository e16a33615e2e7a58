"""sample_decided_per_query: the probes a query the query kernel decided
from the rank records' sample, without reading the record (row 5 of its
stats, `sample_decided`: plquery_kernel's sampled form's, 0 in every
other kernel), from the counted slice (portbench/counted.py), averaged over
every query, each length's batch weighted equally. A program whose
kernels write no such row leaves it out."""

from portbench import counted


def read(run):
    return counted.per_query(run, "sample_decided")
