"""Index memory accounting.

The reference publishes index memory as a plot of hard-coded totals
(eval/Memory/plot_memory.py:15-16: Sapling 80-88 GB on GRCh38 with
size_t-everywhere arrays). The TPU rebuild packs everything; this module
reports the actual bytes per component and the PWL overhead fraction
(the "X% overhead" naming axis used across all reference plots).
"""

from __future__ import annotations


def index_memory_report(index) -> dict:
    t = index.table
    comps = {
        "packed_genome": index.packed.nbytes,
        "rev": index.rev.nbytes,
        "inv": index.inv.nbytes,
        "pwl_xlist": t.xlist.nbytes,
        "pwl_ylist": t.ylist.nbytes,
        "codes_host": 0 if index.codes is None else index.codes.nbytes,
        "lcpk_runs": (
            (0 if index.lcpk_fwd is None else index.lcpk_fwd.nbytes)
            + (0 if index.lcpk_bwd is None else index.lcpk_bwd.nbytes)
        ),
    }
    total = sum(comps.values())
    device_hot = (comps["packed_genome"] + comps["rev"]
                  + comps["pwl_xlist"] + comps["pwl_ylist"])
    pwl = comps["pwl_xlist"] + comps["pwl_ylist"]
    return {
        "components": comps,
        "total_bytes": total,
        "device_hot_bytes": device_hot,
        "pwl_overhead_frac": pwl / max(index.n, 1),
        "bytes_per_base": total / max(index.n, 1),
    }
