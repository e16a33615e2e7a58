"""bisect_steps_per_query: plquery_kernel's phase D (bisection) steps a
query (row 3 of its stats, `d_steps`), from the counted slice
(portbench/counted.py), averaged over every query, each length's batch
weighted equally."""

from portbench import counted


def read(run):
    return counted.per_query(run, "d_steps")
