"""Profiling helpers (port of orc_tpu/utils/profiling.py).

- `trace(log_dir)`: context manager around `torch.profiler.profile`
  (CPU and, when there is one, CUDA activity) that exports a Chrome
  trace into `log_dir` (Perfetto / chrome://tracing open it). The
  solver's spans (below) appear in it as host ranges on the same clock
  as the card's kernels.
- `span(name)`: a named range of the solver's layers (`orc.` names: the
  solve, its preparation and chunks, each SIMPLE iteration and its
  phases, the V-cycle's levels, each counted host read). It records
  only while a torch profiler runs; otherwise it is one shared no-op
  context, so no setting turns spans on or off.
- `to_host(t, site)`: the solve path's reads of a device value on the
  host, each a sync that drains the card's launch queue; counted in
  `to_host.syncs` (reset by assigning 0), as the kernels count their
  launches.
- `measure(fn, *args)` and `measure_bandwidth(fn, bytes_accessed, *args)`:
  median wall time of a call, synchronising the CUDA device of the
  tensors it returns before the clock stops.
- `step_slope(f, x0, n)`: time per step of chained steps x -> f(x), the
  slope between n and n / 8 steps; on the card the steps are queued
  behind a sleeping kernel and timed with CUDA events, so the card's
  time is measured, not the host's dispatch (`bench`'s extended lines).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Callable

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


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while a torch profiler runs, else
    the shared no-op context. The range is a plain host op (not a user
    annotation), so the profiler adds no device-side event for it: the
    card's timeline holds only the kernels, copies and sets, each
    launched inside the innermost open span."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def to_host(t: torch.Tensor, site: str):
    """`t.tolist()` (a Python scalar for a 0-d tensor), counted in
    `to_host.syncs` and, while a profiler runs, inside the span
    `orc.sync.<site>`. Reading a CUDA tensor waits for the card to run
    everything queued before it."""
    to_host.syncs += 1
    with span(f"orc.sync.{site}"):
        return t.tolist()


to_host.syncs = 0


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


_SLEEP_CYCLES_PER_MS = []
#: The sleep each step_slope window is queued behind: longer than the
#: host takes to issue a window that fits the card's launch queue.
STEP_SLOPE_SLEEP_MS = 100.0


def sleep_cycles_per_ms() -> float:
    """Clock cycles of torch.cuda._sleep per millisecond on the current
    card, measured once with CUDA events (it only sizes sleeps)."""
    if not _SLEEP_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def _chain(f, x, n_steps):
    for _ in range(n_steps):
        x = f(x)
    return x


def _window_s(f, x0, n_steps):
    """Seconds of n_steps chained steps from x0. On the card: CUDA events
    around the steps, queued behind a STEP_SLOPE_SLEEP_MS sleep so that
    the card runs them back to back; a window the host has not queued
    within half the sleep (one longer than the card's launch queue, or a
    slow host) is said so on stderr, and its time stands: the card's
    when the card is the slower side. On the CPU: the host clock."""
    x = next(_tensors(x0))
    if not x.is_cuda:
        t0 = time.perf_counter()
        _chain(f, x0, n_steps)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_ms = STEP_SLOPE_SLEEP_MS
    t0 = time.perf_counter()
    torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms()))
    start.record()
    _chain(f, x0, n_steps)
    end.record()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize(x.device)
    if queued_ms >= 0.5 * sleep_ms:
        print(
            f"step_slope: {n_steps} steps took {queued_ms:.1f} ms to queue "
            f"behind a {sleep_ms:.1f} ms sleep",
            file=sys.stderr,
        )
    return start.elapsed_time(end) / 1e3


def step_slope(f: Callable, x0, n: int = 512) -> float:
    """Seconds per step of x -> f(x), each step's output the next one's
    input (x0 a tensor or a tuple of tensors): the slope between windows
    of n and n // 8 steps, each the middle of three after a warm-up step,
    so fixed costs (the first launch, the events) cancel. On a CUDA x0
    the card's time: each window queued behind a sleep and
    timed with CUDA events (keep a window within the card's launch
    queue, about a thousand launches); on the CPU the host clock."""
    _window_s(f, x0, 1)
    n0 = max(1, n // 8)

    def middle(n_steps):
        return sorted(_window_s(f, x0, n_steps) for _ in range(3))[1]

    return (middle(n) - middle(n0)) / (n - n0)
