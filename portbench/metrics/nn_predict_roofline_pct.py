"""nn_predict_roofline_pct: the least time of the traced requests' NN
predictions (portbench.nn_roofline.predict_seconds, from the
configuration's model units and the queries) as a share of the device
time of the `nn_predict_kernel` launches in the traced slice (the
profiler's kernel events); nothing for a configuration without a
model."""

import re

from portbench import nn_roofline

KERNEL = re.compile(r"(?<![A-Za-z_])nn_predict_kernel")


def read(run):
    model = run.cell.config.get("model")
    if run.trace is None or model is None:
        return None
    count, seconds = run.trace.kernel_seconds(KERNEL.search)
    if not count or seconds <= 0:
        return None
    queries = sum(run.batches[length].shape[0] for length in run.traced)
    return (100.0 * nn_roofline.predict_seconds(queries, model["units"])
            / seconds)
