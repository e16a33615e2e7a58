"""Timing device work: CUDA events on a card, the host clock on the CPU."""

from __future__ import annotations

import time

import torch


def timed(fn, device, reps: int = 1, warm: int = 0):
    """(the last fn() result, seconds per call). fn runs `warm` times
    untimed, then `reps` times timed. On a CUDA device the time is that
    between two CUDA events recorded around the timed calls, after
    synchronizing on the second; on the CPU, whose torch ops return when
    done, it is the host clock's."""
    for _ in range(warm):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return out, (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop) / 1e3 / reps
