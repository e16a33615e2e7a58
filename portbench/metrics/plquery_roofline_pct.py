"""plquery_roofline_pct: the least bytes of the traced plQuery requests
(portbench.roofline.plquery_bytes) over the card's HBM peak, as a share
of the device time of the `plquery_kernel` launches in the traced
slice (the profiler's kernel events)."""

import re

from portbench import roofline

KERNEL = re.compile(r"(?<![A-Za-z_])plquery_kernel")


def read(run):
    if run.trace is None:
        return None
    count, seconds = run.trace.kernel_seconds(KERNEL.search)
    if not count or seconds <= 0:
        return None
    per_batch = {length: roofline.plquery_bytes(run.batches[length],
                                                run.k, run.buckets)
                 for length in set(run.traced)}
    least = sum(per_batch[length] for length in run.traced)
    return 100.0 * least / roofline.HBM_BYTES_PER_S / seconds
