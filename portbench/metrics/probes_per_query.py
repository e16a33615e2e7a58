"""probes_per_query: the query kernel's probes a query (row 0 of its
stats, `probes`: each compare of the query against a suffix), from the
counted slice (portbench/counted.py), averaged over every query, each
length's batch weighted equally."""

from portbench import counted


def read(run):
    return counted.per_query(run, "probes")
