"""A cell's iterations by the program's spans: device time, idle time and
host syncs, from the same kind of traced calls as `--trace 1`.

    python3 -m cfdbench.spans --workload <cell> --seeds <n>[,<n>...] [--size N NZ]

The program (orc_tpu_torch) opens `orc.` spans at its layer boundaries
while a torch profiler runs (utils/profiling.span: the solve, its
preparation and chunks, each iteration and its seven phases, the
V-cycle's levels and re-Galerkin products, each counted host read) and
counts its host reads in `profiling.to_host.syncs`. This tool sets a
cell up as a run does (cfdbench.run.make_cell, seeded start, warm-up), traces
two solve_steady calls of 1 and 1 + k iterations with host and CUDA
activity, and reduces each call's events (`reduce_spans`):

- each device operation goes to the spans open on the host when the
  runtime call that launched it ran (the profiler gives the launch and
  the device operation one correlation id): `device` by the innermost
  span, `device_incl` by every open span;
- each idle gap between device operations goes to the spans open when
  it began: `idle`, `idle_incl`;
- `extent`: from a span's first start to the later of its last end and
  the end of the last device operation launched inside it.

It prints one JSON line a seed: per iteration over the difference of the two
calls, the host syncs (the counter's increase), the pressure solve's
device and idle milliseconds (at any depth), every span's inclusive
device milliseconds; the 1-iteration call's `orc.prepare` extent; the
1 + k call's largest spans by device and by idle time; and the idle
share and window that cfdbench.trace reads from the same events.
`python3 -m cfdbench` does not call this module: no metric of
BENCHMARK.json reads spans.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from cfdbench.trace import _merge, reduce_events

#: Innermost span of work launched, or of a gap begun, outside any span.
OUTSIDE = "(no span)"
SPAN_PREFIX = "orc."
#: Host events that launch device work: runtime and driver API calls.
LAUNCH_PREFIXES = ("cu",)


@dataclasses.dataclass
class SpanTrace:
    device: dict  # innermost span -> device seconds
    device_incl: dict  # span -> device seconds launched at any depth in it
    idle: dict  # innermost span open when a gap began -> idle seconds
    idle_incl: dict  # span -> idle seconds of gaps begun at any depth in it
    extent: dict  # span -> seconds from its first start to its work's end
    count: dict  # span -> occurrences

    def minus(self, other: "SpanTrace") -> "SpanTrace":
        def sub(a, b):
            return {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)}

        return SpanTrace(
            *(sub(getattr(self, f.name), getattr(other, f.name)) for f in dataclasses.fields(self))
        )

    @staticmethod
    def top(d, n=10):
        return [[k, v] for v, k in sorted(((v, k) for k, v in d.items()), reverse=True)[:n]]


def _open_spans(spans, times):
    """For each of the ascending `times`, the spans open then, outermost
    first. `spans` are (name, start, end), properly nested."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    stack, j, out = [], 0, []
    for t in times:
        while j < len(spans) and spans[j][1] <= t:
            while stack and stack[-1][2] <= spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(list(stack))
    return out


def reduce_spans(device, host) -> SpanTrace:
    """A SpanTrace from device events (name, start_us, end_us, id) and host
    events (name, start_us, end_us, id): the `orc.` spans and the runtime
    calls among the host events, matched to device events by id."""
    spans = [(n, s, e) for n, s, e, _ in host if n.startswith(SPAN_PREFIX)]
    launch = {i: s for n, s, _, i in host if n.startswith(LAUNCH_PREFIXES)}
    ops = sorted((launch.get(i, s), s, e) for _, s, e, i in device)
    dev, dev_incl, idle, idle_incl = {}, {}, {}, {}
    last_end = {}
    for (_, s, e), open_ in zip(ops, _open_spans(spans, [op[0] for op in ops])):
        key = open_[-1][0] if open_ else OUTSIDE
        dev[key] = dev.get(key, 0.0) + (e - s) * 1e-6
        for name in {sp[0] for sp in open_}:
            dev_incl[name] = dev_incl.get(name, 0.0) + (e - s) * 1e-6
            last_end[name] = max(last_end.get(name, e), e)
    busy = _merge([(s, e) for _, s, e in ops])
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]
    for (e0, s1), open_ in zip(gaps, _open_spans(spans, [g[0] for g in gaps])):
        key = open_[-1][0] if open_ else OUTSIDE
        idle[key] = idle.get(key, 0.0) + (s1 - e0) * 1e-6
        for name in {sp[0] for sp in open_}:
            idle_incl[name] = idle_incl.get(name, 0.0) + (s1 - e0) * 1e-6
    first, last, count = {}, {}, {}
    for n, s, e in spans:
        first[n] = min(first.get(n, s), s)
        last[n] = max(last.get(n, e), e)
        count[n] = count.get(n, 0) + 1
    extent = {n: (max(last[n], last_end.get(n, last[n])) - first[n]) * 1e-6 for n in first}
    return SpanTrace(dev, dev_incl, idle, idle_incl, extent, count)


def profiled(fn, on_card: bool = True):
    """Run `fn` under the profiler as cfdbench.trace.traced does; returns
    (device events, host events, window seconds), each event (name,
    start_us, end_us, id)."""
    import torch
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
        row = (ev.name, ev.time_range.start, ev.time_range.end, ev.id)
        if ev.device_type == DeviceType.CUDA:
            device.append(row)
        else:
            host.append(row)
    return device, host, window_s


def measure(cell, seed: int) -> dict:
    """From the seeded start of a cell set up as a run sets it up
    (cfdbench.run.make_cell), warm up, trace calls of 1 and 1 + k iterations
    and reduce them; the JSON-ready result."""
    import torch

    from cfdbench.run import _sync, log
    from orc_tpu_torch.utils.profiling import to_host

    spec, device = cell.spec, cell.device
    wl, on_card = spec.workload, cell.on_card
    s, _ = cell.solve(cell.start(seed), 1)
    s, _ = cell.solve(s, int(wl["warmup_iterations"]))
    _sync(device)
    k = int(wl["trace_iterations"])
    calls = []
    for n in (1, 1 + k):
        before = to_host.syncs
        dev, host, window_s = profiled(lambda: cell.solve(s, n), on_card)
        calls.append((to_host.syncs - before, dev, host, window_s))
    log(f"traced 1 and {1 + k} iterations of {cell.mesh.n_cells} cells")
    (sync1, dev1, host1, w1), (syncm, devm, hostm, wm) = calls
    one, more = reduce_spans(dev1, host1), reduce_spans(devm, hostm)
    sub = more.minus(one)
    t_one = reduce_events([e[:3] for e in dev1], [e[:3] for e in host1], w1)
    t_more = reduce_events([e[:3] for e in devm], [e[:3] for e in hostm], wm)
    t_sub = t_more.minus(t_one)
    per_iter_ms = {n: 1e3 * v / k for n, v in sorted(sub.device_incl.items())}
    return {
        "workload": spec.name,
        "seed": seed,
        "dims": None if cell.dims is None else list(cell.dims),
        "k": k,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "host_syncs_per_iter": (syncm - sync1) / k,
        "host_syncs": [sync1, syncm],
        "p_solve_ms_per_iter": per_iter_ms.get("orc.pressure_solve"),
        "p_solve_idle_ms_per_iter": 1e3 * sub.idle_incl.get("orc.pressure_solve", 0.0) / k,
        "prepare_ms": 1e3 * one.extent.get("orc.prepare", 0.0),
        "idle_pct": 100.0 * (1.0 - t_sub.busy_s / t_sub.window_s) if t_sub.window_s > 0 else None,
        "window_s": [w1, wm],
        "busy_s": [t_one.busy_s, t_more.busy_s],
        "device_ms_per_iter_by_span": per_iter_ms,
        "spans_per_iter": {n: c / k for n, c in sorted(sub.count.items())},
        "device_by_span": SpanTrace.top(more.device),
        "idle_by_span": SpanTrace.top(more.idle),
        "idle_gaps": t_more.top_gaps(),
    }


def main(argv=None) -> int:
    from cfdbench.run import load_spec, make_cell

    ap = argparse.ArgumentParser(prog="python3 -m cfdbench.spans", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated; one line each, on one mesh")
    ap.add_argument("--size", type=int, nargs=2, metavar=("N", "NZ"), help="override the cell's mesh size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = make_cell(load_spec(args.workload), args.device, tuple(args.size) if args.size else None)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(measure(cell, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
