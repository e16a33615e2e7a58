"""nn_plquery_roofline_pct: the least bytes of the traced NN requests'
plQuery (portbench.nn_roofline.plquery_bytes: packed words, k-mers,
predictions, positions) over the card's HBM peak, as a share of the
device time of the `plquery_kernel` launches in the traced slice (the
profiler's kernel events); nothing for a configuration without a model,
whose plquery predicts from the PWL table."""

import re

from portbench import nn_roofline, roofline

KERNEL = re.compile(r"(?<![A-Za-z_])plquery_kernel")


def read(run):
    if run.trace is None or "model" not in run.cell.config:
        return None
    count, seconds = run.trace.kernel_seconds(KERNEL.search)
    if not count or seconds <= 0:
        return None
    least = sum(nn_roofline.plquery_bytes(run.batches[length])
                for length in run.traced)
    return 100.0 * least / roofline.HBM_BYTES_PER_S / seconds
