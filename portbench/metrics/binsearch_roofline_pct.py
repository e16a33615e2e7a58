"""binsearch_roofline_pct: the least bytes of the traced binary-search
requests (portbench.roofline.binsearch_bytes) over the card's HBM peak,
as a share of the device time of the `binsearch_kernel` launches in the
traced slice (the profiler's kernel events; the pruned search's
`fancy_binsearch_kernel` is not this kernel)."""

import re

from portbench import roofline

KERNEL = re.compile(r"(?<![A-Za-z_])binsearch_kernel")


def read(run):
    if run.trace is None:
        return None
    count, seconds = run.trace.kernel_seconds(KERNEL.search)
    if not count or seconds <= 0:
        return None
    least = sum(roofline.binsearch_bytes(run.batches[length])
                for length in run.traced)
    return 100.0 * least / roofline.HBM_BYTES_PER_S / seconds
