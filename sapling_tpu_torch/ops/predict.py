"""Exact piecewise-linear prediction with integer rational arithmetic.

The reference evaluates the PWL index in C++ `double`
(reference: src/sapling_api.h:98-109):

    predict = (long long)(.5 + ylo + (yhi - ylo) * ((x - xlo) * 1. / (xhi - xlo)))

The same quantity is computed here with exact int64 rational arithmetic:
round-half-up of ylo + M*N/D where M = yhi-ylo >= 0, N = x-xlo, D = xhi-xlo.
The 128-bit product M*N (up to ~2^74 for k=21 human-scale inputs) is
handled by splitting N in base 2^16 and propagating remainders through two
exact int64 floor divisions of non-negative operands, so no float ever
enters and the result is bit-identical on the CPU and the card.

One function serves both callers: `xp=torch` (the default) for int64
tensors on any device, and `xp=np` for the host-side build audit
(index.pwl).
"""

from __future__ import annotations

import numpy as np
import torch


def _divmod_nonneg(p, d):
    """Exact (q, r) for p >= 0, d > 0, works on tensors or numpy arrays."""
    q = p // d
    return q, p - q * d


def predict_pwl(x, xlist, ylist, kbits: int, buckets: int, n: int, xp=torch):
    """Batched PWL prediction.

    x:      int64 [B] k-mer values
    xlist:  int64 [2^buckets + 1]
    ylist:  int64 [2^buckets + 1]
    kbits:  2*k (total bits in a k-mer value)
    n:      genome length (predictions are clamped to [0, n-1]; the reference
            clamps only below at 0 — src/sapling_api.h:107 — and reads
            rev[] out of bounds for x beyond the last checkpoint, which we
            refuse to reproduce).
    xp:     torch (tensors on one device) or np (host arrays).

    Returns int64 [B] predicted suffix-array ranks.
    """
    bucket = x >> (kbits - buckets)
    xlo, xhi = xlist[bucket], xlist[bucket + 1]
    ylo, yhi = ylist[bucket], ylist[bucket + 1]
    return _predict_from_parts(x, xlo, xhi - xlo, ylo, yhi - ylo, n, xp)


def _predict_from_parts(x, xlo, d, ylo, m, n, xp):
    # m = yhi - ylo >= 0 (ylist nondecreasing), < n
    # d = xhi - xlo > 0 unless degenerate bucket
    nn = x - xlo           # may be negative for out-of-genome kmers

    a = xp.abs(nn)
    nh = a >> 16
    nl = a & 0xFFFF
    d_safe = xp.where(d == 0, 1, d)
    q1, r1 = _divmod_nonneg(m * nh, d_safe)
    q2, r2 = _divmod_nonneg((r1 << 16) + m * nl, d_safe)
    q = (q1 << 16) + q2
    r = r2
    # round-half-up of ylo + sign * (q + r/d): see module docstring.
    pred_pos = ylo + q + xp.where(2 * r >= d_safe, 1, 0)
    pred_neg = ylo - q - xp.where(2 * r > d_safe, 1, 0)
    pred = xp.where(nn >= 0, pred_pos, pred_neg)
    pred = xp.where(d == 0, ylo, pred)
    return xp.clip(pred, 0, n - 1)


def predict_pwl_f64(x, xlist, ylist, kbits: int, buckets: int, n: int):
    """NumPy float64 oracle with the reference's exact C++ double semantics
    (src/sapling_api.h:98-109), including no upper clamp. Host-side only;
    the errFn dump of tools.sapling_example writes its predictions."""
    shift = kbits - buckets
    bucket = x >> shift
    xlo = xlist[bucket]
    xhi = xlist[bucket + 1]
    ylo = ylist[bucket]
    yhi = ylist[bucket + 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (x - xlo).astype(np.float64) / (xhi - xlo).astype(np.float64)
    val = 0.5 + ylo + (yhi - ylo) * ratio
    pred = val.astype(np.int64)  # C-style truncation toward zero
    pred = np.where(pred < 0, 0, pred)
    pred = np.where(xlo == xhi, ylo, pred)
    return pred
