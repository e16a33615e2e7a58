"""genome_sectors_per_query: the sectors of the packed genome among a
query's sectors in the query kernel (row 4 of its stats,
`genome_sectors`: on rank records the ties past their 32 bases, on rev
and the genome every probe's window), from the counted slice
(portbench/counted.py), averaged over every query, each length's batch
weighted equally."""

from portbench import counted


def read(run):
    return counted.per_query(run, "genome_sectors")
