"""sectors_per_query: the 32-byte sectors a query's reads touch in the
query kernel (row 1 of its stats, `sectors`: records, rev, the packed
genome, a prediction's bucket record), from the counted slice
(portbench/counted.py), averaged over every query, each length's batch
weighted equally."""

from portbench import counted


def read(run):
    return counted.per_query(run, "sectors")
