"""Device traces of a few whole iterations, reduced to what the per-layer
metrics read.

`traced(fn)` runs `fn` under torch.profiler (host and CUDA activity) and
returns a `Trace`: device time and launches by kernel name, the busy
time (the union of the device intervals), the wall time of the call,
and the idle gaps between device work, each named by the innermost host
operation running when the gap began. `Trace.minus` takes one trace
from another, so a window of 1 + k iterations less a window of 1 gives k
iterations without the call's own preparation. The arithmetic is that of
chip_smoke.py's `profile_window` (busy share = device time over wall,
launches per iteration), copied here, with gaps added.
"""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class Trace:
    kernels: dict  # name -> [launches, device seconds]
    busy_s: float
    window_s: float
    gaps: dict  # host op -> idle seconds

    def minus(self, other: "Trace") -> "Trace":
        names = set(self.kernels) | set(other.kernels)
        kernels = {}
        for n in names:
            a = self.kernels.get(n, [0, 0.0])
            b = other.kernels.get(n, [0, 0.0])
            kernels[n] = [a[0] - b[0], a[1] - b[1]]
        gaps = {n: self.gaps.get(n, 0.0) - other.gaps.get(n, 0.0) for n in set(self.gaps) | set(other.gaps)}
        return Trace(kernels, self.busy_s - other.busy_s, self.window_s - other.window_s, gaps)

    def top_ops(self, n=10):
        rows = sorted(((v[1], k) for k, v in self.kernels.items()), reverse=True)[:n]
        return [[k, s] for s, k in rows]

    def top_gaps(self, n=10):
        rows = sorted(((v, k) for k, v in self.gaps.items()), reverse=True)[:n]
        return [[k, s] for s, k in rows]


def _merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(device, host, window_s) -> Trace:
    """A Trace from device events (name, start_us, end_us), host events
    (name, start_us, end_us) and the wall seconds of the window."""
    kernels = {}
    for name, s, e in device:
        row = kernels.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += (e - s) * 1e-6
    busy = _merge([(s, e) for _, s, e in device])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = {}
    # The innermost host op open when each gap began: host ops nest, so
    # a stack of the open ones, pushed in start order, has it on top.
    host = sorted(host, key=lambda h: h[1])
    stack, j = [], 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        while j < len(host) and host[j][1] <= e0:
            while stack and stack[-1][2] <= host[j][1]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] <= e0:
            stack.pop()
        key = stack[-1][0] if stack else "(python, between host ops)"
        gaps[key] = gaps.get(key, 0.0) + (s1 - e0) * 1e-6
    return Trace(kernels, busy_s, window_s, gaps)


def traced(fn, on_card: bool = True) -> Trace:
    """Run `fn` under the profiler (host activity, and the card's when
    `on_card`), the window ending in a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            device.append((ev.name, tr.start, tr.end))
        else:
            host.append((ev.name, tr.start, tr.end))
    return reduce_events(device, host, window_s)
