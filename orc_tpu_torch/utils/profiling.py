"""Profiling helpers (port of orc_tpu/utils/profiling.py).

- `trace(log_dir)`: context manager around `torch.profiler.profile`
  (CPU and, when there is one, CUDA activity) that exports a Chrome
  trace into `log_dir` (Perfetto / chrome://tracing open it).
- `Timer`: lightweight host timing of named phases.
- `measure(fn, *args)` and `measure_bandwidth(fn, bytes_accessed, *args)`:
  median wall time of a call, synchronising the CUDA device of the
  tensors it returns before the clock stops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str = "orc_tpu_torch_trace"):
    """Profile the body; on exit write `<log_dir>/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.phases[name] = self.phases.get(name, 0.0) + (
            time.perf_counter() - t0
        )

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [
            f"{k:>24}: {v*1e3:9.2f} ms ({100*v/total:5.1f}%)"
            for k, v in sorted(self.phases.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _tensors(getattr(out, f.name))


def block_until_ready(out):
    """Wait for every CUDA device that holds a tensor of `out` (a tensor
    or a nest of tuples, lists, dicts and dataclasses such as FlowState);
    returns `out`."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out


def measure(fn: Callable, *args, warmup: int = 2, iters: int = 10):
    """Median wall time of fn(*args) with device sync. Returns seconds."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def measure_bandwidth(fn: Callable, bytes_accessed: int, *args, **kw):
    """(seconds, GB/s) for a memory-bound op."""
    t = measure(fn, *args, **kw)
    return t, bytes_accessed / t / 1e9
