"""Tracing, profiling and structured logging (the twin of
sapling_tpu/utils/profiling.py).

The reference's only instrumentation is wall-clock around the query loop
(reference: src/sapling_example.cpp:134-141) and cout progress lines.
Here:
  * device-fenced timers (the device synchronized before and after) so
    numbers mean device time, not the time to enqueue;
  * torch.profiler traces, written as Chrome traces (chrome://tracing,
    Perfetto);
  * structured one-line JSON event logging.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch

from .timing import timed


def _cuda_devices(x) -> set:
    """The CUDA devices of the tensors in x (a tensor, or a list, tuple or
    dict of them, nested)."""
    if isinstance(x, torch.Tensor):
        return {x.device} if x.is_cuda else set()
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in x))
    return set()


def _sync(x) -> None:
    for dev in _cuda_devices(x):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_timer(name: str, sink=None, pending=None):
    """Fenced wall-clock timer: waits for the devices of `pending`
    (tensors) before starting and for those of the block's result,
    sink['result'] if the block sets it, before stopping."""
    _sync(pending)
    t0 = time.perf_counter()
    out = {}
    yield out
    if "result" in out:
        _sync(out["result"])
    out["seconds"] = time.perf_counter() - t0
    log_event("timer", name=name, seconds=out["seconds"], **(sink or {}))


def _trace_counts(path: str) -> tuple[int, int]:
    """(device kernel events, kernel launches on the host) in a Chrome
    trace that torch.profiler exported."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(e.get("cat") == "kernel" for e in events)
    launches = sum(e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "LaunchKernel" in e.get("name", "") for e in events)
    return kernels, launches


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler trace context: CPU activity, and CUDA activity where
    a card is present; on exit the trace is written into log_dir as a
    Chrome trace. Yields a dict that then holds "path" and "kernels" (the
    trace's device kernel events). With a card, a trace that holds kernel
    launches but no kernel event raises: the profiler dropped the card's
    activity."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    out = {}
    with profile(activities=activities) as prof:
        yield out
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    kernels, launches = _trace_counts(path)
    if cuda and launches and not kernels:
        raise RuntimeError(f"torch.profiler recorded {launches} kernel "
                           f"launches and no kernel on the card ({path})")
    out.update(path=path, kernels=kernels)


def log_event(kind: str, stream=None, **fields):
    """One-line JSON structured log record."""
    rec = {"t": round(time.time(), 3), "kind": kind}
    rec.update(fields)
    print(json.dumps(rec), file=stream or sys.stderr, flush=True)


def bench_fn(fn, *args, warmup: int = 1, iters: int = 3):
    """Time fn(*args): `warmup` untimed calls, then the minimum over
    `iters` fenced calls (utils.timing.timed: CUDA events on the device of
    the warm-up result's tensors, the host clock without one). Returns
    (seconds_min, result)."""
    result = None
    for _ in range(max(warmup, 1)):
        result = fn(*args)
    devs = sorted(_cuda_devices(result), key=str)
    dev = devs[0] if devs else torch.device("cpu")
    best = float("inf")
    for _ in range(max(iters, 1)):
        result, dt = timed(lambda: fn(*args), dev)
        best = min(best, dt)
    return best, result
