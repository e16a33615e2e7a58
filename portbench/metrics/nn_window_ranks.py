"""nn_window_ranks: the served NN model's max window, max_over +
max_under ranks (the audit's largest errors over every genome k-mer, the
ranks a present query's bisection may have to cover), as the run's entry
served it (portbench.nn_model.SERVED); nothing for a configuration
without a model."""

from portbench import nn_model


def read(run):
    served = nn_model.SERVED
    if "model" not in run.cell.config or "max_over" not in served:
        return None
    return served["max_over"] + served["max_under"]
