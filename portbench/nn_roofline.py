"""The least work of the NN engine's two kernels, counted from the model's
spec and a batch's queries alone, so that every design of the program is
held to the same work.

  * `nn_predict_kernel`: 5 s + 13 fp64 operations a query at s units a
    hidden layer (the int64 -> fp64 conversion, the division, the rounding
    to float32 and back; for each unit a multiply, an add and a ReLU, and
    a multiply and, but the first, an add for the sum; the second bias;
    the un-scaling's two multiplies, two adds and a subtract; the
    rounding, the two clamp compares and the conversion to int64: the
    count of `chip_smoke.nn_bound_ms`), one an fp64 lane a clock on 132
    SMs x 64 fp64 lanes at 1980 MHz; and 16 bytes a query (its k-mer read,
    its rank written) at the HBM peak. Its least time is the larger.
  * `plquery_kernel` on the NN's predictions: each query's packed words,
    its k-mer and its prediction read once, 8 bytes each, and its position
    written once, 8 bytes; no PWL checkpoint is read.
"""

from __future__ import annotations

import numpy as np

from .roofline import HBM_BYTES_PER_S, KMER_BYTES, io_bytes

# NVIDIA H100 SXM data sheet: SMs, fp64 lanes an SM, the max SM clock
SMS = 132
FP64_LANES_PER_SM = 64
SM_CLOCK_HZ = 1.98e9
PREDICT_BYTES_PER_QUERY = 16
PRED_BYTES = 8


def predict_ops(queries: int, units: int) -> int:
    """fp64 operations of nn_predict over `queries` k-mers."""
    return queries * (5 * units + 13)


def predict_seconds(queries: int, units: int) -> float:
    """The least time of nn_predict over `queries` k-mers: the larger of
    its operations at the fp64 peak and its bytes at the HBM peak."""
    return max(predict_ops(queries, units)
               / (SMS * FP64_LANES_PER_SM * SM_CLOCK_HZ),
               queries * PREDICT_BYTES_PER_QUERY / HBM_BYTES_PER_S)


def plquery_bytes(rows: np.ndarray) -> int:
    """The least bytes of the NN engine's plquery over these queries."""
    return io_bytes(rows) + rows.shape[0] * (KMER_BYTES + PRED_BYTES)
