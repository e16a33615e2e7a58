"""Reading a torch.profiler Chrome trace: the device's operations inside
the traced window, its busy time, and the host's work in its idle gaps.

The window is the span of the host annotation that the harness opens
around the traced requests. Device operations are the trace's `kernel`,
`gpu_memcpy` and `gpu_memset` events; busy time is the length of their
union inside the window. An idle gap is a stretch of the window in which
no device operation runs; it is named after the innermost host event
(an annotation, a torch op or a CUDA runtime call) under way at its
middle.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    window: tuple[float, float]        # seconds on the trace's clock
    device_ops: list = field(default_factory=list)   # (name, start, end)
    host_ops: list = field(default_factory=list)     # (name, start, end)
    launches: int = 0                  # kernel launches the host made

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def clipped(self):
        """The device operations inside the window, clipped to it."""
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.device_ops
                if e > lo and s < hi]

    def busy_intervals(self):
        """The union of the device operations inside the window, merged,
        in order."""
        merged = []
        for _, s, e in sorted(self.clipped(), key=lambda t: t[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_seconds(self, match) -> tuple[int, float]:
        """(count, seconds) of the device operations inside the window
        whose name `match(name)` accepts."""
        hits = [e - s for n, s, e in self.clipped() if match(n)]
        return len(hits), sum(hits)

    def top_device_ops(self, limit: int = 10):
        """[[name, seconds]] of the device operations that took most time
        in the window, summed by name."""
        by = {}
        for n, s, e in self.clipped():
            by[n] = by.get(n, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])
                ][:limit]

    def idle_gaps(self, limit: int = 10):
        """[[host activity, seconds]]: the window's idle time summed by
        what the host was doing, the longest first."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        by = {}
        for s, e in gaps:
            name = self.host_at((s + e) / 2)
            by[name] = by.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])
                ][:limit]

    def host_at(self, t: float) -> str:
        """The innermost host event under way at time t."""
        best = None
        for n, s, e in self.host_ops:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (n, e - s)
        return best[0] if best else "host (no event)"


def read_trace(path: str, window_name: str) -> Trace:
    """The Trace of a Chrome trace file, its window the first host
    annotation named `window_name`."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window, device, host, launches = None, [], [], 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        start = float(e["ts"]) * 1e-6
        end = start + float(e.get("dur", 0)) * 1e-6
        if cat in DEVICE_CATS:
            device.append((name, start, end))
        elif cat in HOST_CATS:
            if cat == "user_annotation" and name == window_name \
                    and window is None:
                window = (start, end)
            host.append((name, start, end))
            if cat in ("cuda_runtime", "cuda_driver") and "LaunchKernel" in name:
                launches += 1
    if window is None:
        raise ValueError(f"{path}: no host annotation {window_name!r}")
    return Trace(window=window, device_ops=device, host_ops=host,
                 launches=launches)
