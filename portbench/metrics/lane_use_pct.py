"""lane_use_pct: the share of the query kernel's probe slots that do a
lane's probe: Σ probes (row 0 of its stats) over 32 × Σ each warp's
deepest lane, a warp being 32 consecutive queries as the kernels map
them (chip_smoke.lane_utilisation's definition), over every batch of the
counted slice (portbench/counted.py)."""

from portbench import counted


def read(run):
    return counted.lane_use_pct(run)
