"""The benchmark of orc_tpu_torch: one cell, one run.

    python3 -m cfdbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (BENCHMARK.json `workloads`) names a configuration
(configs/<config>.json: the deployment, its numerics and boundaries, the
reference that judges it) and has a file of its own (workloads/<cell>.json:
the mesh size, the seeded start, the limits of the check). One run:

1. set-up: the port's kernel library (built into build/orc_tpu_torch/ in
   the checkout on the first run, its seconds reported apart), the mesh
   on the card, the configuration's boundaries and numerics, the fluid
   at rest plus a normal perturbation drawn from --seed on the card, then
   warm-up calls of solve_steady at the cell's own shapes. The mesh is a
   generated box (models/cavity.cavity_case, Cell) or, for a
   configuration with a `case`, the TGRID file its generator writes once
   into build/cfdbench/meshes/ (cfdbench/meshes; its seconds reported
   apart), read through the CLI's case path (MeshCell);
2. the window: one solve_steady call, as users make it, of as many
   iterations as fill about --seconds at the warm-up's rate; the rate
   is its iterations over its wall time, ending in a synchronize;
3. with --trace 1, two profiled calls of 1 and 1 + k iterations, whose
   difference gives the per-layer metrics of k whole iterations
   (metrics/<name>.py);
4. the check: the program's first judge.BLOCK iterations from the
   seeded start (the warm-up's first call, then single iterations from
   it after the window) and as many single iterations after the window,
   each recomputed by the plain reference (reference/: box.py on a box,
   mesh.py on a mesh case, whose cells and faces layout_mesh.py matches
   to the file's first) once the program's mesh and state are freed.

The last line of standard output is one JSON object; the numbers of the
check, each beside its limit, close standard error and that line.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time
import types
from pathlib import Path


def _process_start() -> float:
    """time.monotonic() at the start of this process (from /proc where
    it exists, else now)."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orc_tpu")
GIB = float(1 << 30)


# --- the cell's files ----------------------------------------------------------


def load_spec(cell: str, bench_path: Path | None = None, files: Path | None = None):
    """(BENCHMARK.json, its cell entry, the configuration, the workload
    file) of a cell, each found by name: configs/ and workloads/ under
    `files` (the benchmark's own, or tests/fixtures/ for the tests)."""
    bench = json.loads((bench_path or CHECKOUT / "BENCHMARK.json").read_text())
    entries = [w for w in bench["workloads"] if w["name"] == cell]
    if not entries:
        raise SystemExit(f"no cell named {cell!r} in BENCHMARK.json")
    entry, files = entries[0], files or HERE
    config = json.loads((files / "configs" / f"{entry['config']}.json").read_text())
    workload = json.loads((files / "workloads" / f"{cell}.json").read_text())
    if workload["config"] != entry["config"]:
        raise SystemExit(f"workloads/{cell}.json names {workload['config']}, BENCHMARK.json {entry['config']}")
    return types.SimpleNamespace(bench=bench, entry=entry, config=config, workload=workload, name=cell)


def _toml_value(v):
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    return repr(v)


def _numerics_lines(config: dict):
    num = dict(config["numerics"])
    solver = num.pop("solver", {})
    lines = ["[numerics]"] + [f"{k} = {_toml_value(v)}" for k, v in num.items()]
    return lines + ["[numerics.solver]"] + [f"{k} = {_toml_value(v)}" for k, v in solver.items()]


def settings_of(config: dict, dims):
    """The port's NumericalSettings of a configuration, through the case
    file parser the CLI uses (utils/config.parse_case)."""
    from orc_tpu_torch.utils.config import parse_case

    lines = ["[case.generate]", f"nx = {dims[0]}", f"ny = {dims[1]}", f"nz = {dims[2]}"]
    return parse_case("\n".join(lines + _numerics_lines(config)) + "\n").settings


def case_text(config: dict, mesh_path) -> str:
    """The case file of a mesh case, as a user writes it: the mesh file,
    the fluid, the numerics and the configuration's boundaries."""
    lines = ["[case]", f"mesh = {json.dumps(str(mesh_path))}", "[fluid]"]
    lines += [f"{k} = {_toml_value(v)}" for k, v in config["fluid"].items()]
    lines += _numerics_lines(config)
    for zone, bc in config["boundaries"].items():
        lines.append(f"[boundaries.{json.dumps(zone)}]")
        lines += [f"{k} = {_toml_value(v)}" for k, v in bc.items()]
    return "\n".join(lines) + "\n"


def log(msg):
    print(f"cfdbench [{time.monotonic() - T_START:7.1f} s] {msg}", file=sys.stderr, flush=True)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels() -> float:
    """Seconds spent building the port's kernel library (0 when it was
    already built in this checkout)."""
    from orc_tpu_torch.ops import _cuda

    was_stale = _cuda.is_stale()
    t = time.perf_counter()
    _cuda.library()
    return time.perf_counter() - t if was_stale else 0.0


def per_layer_names(spec):
    return [
        m["name"] for m in spec.bench["per_layer"]
        if spec.name in m.get("workloads", [spec.name])
    ]


def end_to_end_names(spec):
    return [
        m["name"] for m in spec.bench["end_to_end"]
        if spec.name in m.get("workloads", [spec.name])
    ]


def units(spec):
    return {m["name"]: m["unit"] for m in spec.bench["end_to_end"] + spec.bench["per_layer"]}


# --- one run --------------------------------------------------------------------


class Cell:
    """The program set up for one cell: mesh and table on the device,
    the configuration's boundaries and numerics, `solve(state, n)` as
    users call solve_steady, `start(seed)` the seeded state."""

    def __init__(self, spec, device="cuda", size=None):
        import torch

        from orc_tpu_torch.mesh.zones import FaceCondition
        from orc_tpu_torch.models import cavity
        from orc_tpu_torch.solver import simple

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.spec, self.device = spec, device
        self.on_card = torch.device(device).type == "cuda"
        cfg, wl = spec.config, spec.workload
        n, nz = size or (wl["n"], wl["nz"])
        self.dims = (n, n, nz)
        self.lengths = (1.0, 1.0, nz / n)  # cavity_case's box
        self.dtype = getattr(torch, cfg["dtype"])
        self.rho, self.mu = float(cfg["fluid"]["rho"]), float(cfg["fluid"]["mu"])
        self.compile_s = build_kernels() if self.on_card else None
        t = time.perf_counter()
        self.mesh, self.table = cavity.cavity_case(
            n, nz, lid_velocity=cfg["lid_velocity"], dtype=self.dtype, device=device
        )
        for zone, bc in cfg["boundaries"].items():
            self.table.set(zone, FaceCondition[bc["type"].upper()], vector_value=bc.get("velocity"))
        _sync(device)
        self.mesh_build_s = time.perf_counter() - t
        self.settings = settings_of(cfg, self.dims)
        self._simple = simple

    def start(self, seed: int):
        """The fluid at rest plus the workload's normal perturbation,
        drawn on the device from `seed`."""
        import torch

        C, dev, dt = self.mesh.n_cells, self.device, self.dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        amp = self.spec.workload["perturbation"]
        vel = amp["velocity"] * torch.randn((C, 3), generator=gen, device=dev, dtype=dt)
        p = amp["pressure"] * torch.randn((C,), generator=gen, device=dev, dtype=dt)
        return self._simple.initial_state(self.mesh, vel=vel, p=p)

    def solve(self, state, iterations):
        return self._simple.solve_steady(
            self.mesh, self.table, self.settings, self.rho, self.mu, state=state,
            iterations=iterations, reporting_interval=200, verbose=False, use_ck="auto",
        )

    def layout(self):
        from cfdbench.layout import Layout

        return Layout(self.mesh, self.dims, tuple(L / d for L, d in zip(self.lengths, self.dims)))

    def box(self):
        """The reference's geometry: a uniform Box."""
        import torch

        from cfdbench.reference import box as fv

        return fv.make_box(self.dims, self.lengths, self.spec.config["boundaries"], torch.float64, self.device)


class MeshCell(Cell):
    """The program set up for a mesh case (a configuration with `case`):
    the case's TGRID file, generated once into build/cfdbench/meshes/ in
    the checkout (cfdbench/meshes), read as users read one, through the
    case file parser and `build_problem` (utils/config.py: the TGRID
    parser, reverse Cuthill-McKee, the slice plan, the boundaries by
    zone). `size` overrides the case's generator parameters."""

    def __init__(self, spec, device="cuda", size=None):
        import torch

        from cfdbench.meshes.tgrid import mesh_file
        from orc_tpu_torch.solver import simple
        from orc_tpu_torch.utils.config import build_problem, parse_case

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.spec, self.device = spec, device
        self.on_card = torch.device(device).type == "cuda"
        cfg = spec.config
        self.case = dict(cfg["case"], **(size or {}))
        self.dims = None
        self.dtype = getattr(torch, cfg["dtype"])
        self.compile_s = build_kernels() if self.on_card else None
        path, self.mesh_file_s, self._grid = mesh_file(self.case, CHECKOUT / "build" / "cfdbench" / "meshes")
        self.mesh_file_bytes = path.stat().st_size
        t = time.perf_counter()
        case = parse_case(case_text(cfg, path))
        mesh, self.table = build_problem(case, device=device)
        self.mesh = as_dtype(mesh, self.dtype)
        _sync(device)
        self.mesh_build_s = time.perf_counter() - t
        self.settings, self.rho, self.mu = case.settings, case.rho, case.mu
        self._simple = simple
        self._ref = None

    def box(self):
        """The reference's geometry: the generator's face list, in
        float64 (reference/mesh.py)."""
        import torch

        from cfdbench.meshes import generator
        from cfdbench.reference import mesh as fm

        if self._ref is None:
            params = {k: v for k, v in self.case.items() if k != "generator"}
            grid = self._grid or generator(self.case["generator"]).generate(**params)
            self._ref = fm.make_mesh(grid, self.spec.config["boundaries"], torch.float64, self.device)
            self._grid = None
        return self._ref

    def layout(self):
        from cfdbench.layout_mesh import MeshLayout

        return MeshLayout(self.mesh, self.box())


def as_dtype(mesh, dtype):
    """A compiled mesh with its floating-point fields in `dtype`. The
    compiler derives every field in float64 and rounds it once, so this
    equals reading the file in `dtype` (build_problem reads in float64)."""
    import dataclasses

    import torch

    if mesh.dtype == dtype:
        return mesh
    cast = {}
    for f in dataclasses.fields(mesh):
        v = getattr(mesh, f.name)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            cast[f.name] = v.to(dtype)
    return dataclasses.replace(mesh, **cast)


def make_cell(spec, device="cuda", size=None):
    """The program set up for a cell: a generated box (Cell), or a mesh
    case (MeshCell) where the configuration has `case`."""
    return (MeshCell if "case" in spec.config else Cell)(spec, device, size)


def chain(solve, state, n):
    """`state` and the states that n single iterations lead to from it,
    with the iterations' histories."""
    states, histories = [state], []
    for _ in range(n):
        s, h = solve(states[-1], 1)
        states.append(s)
        histories.append(h)
    return states, histories


def run_cell(spec, seed: int, seconds: float, trace: bool, device="cuda", size=None):
    """One run of a cell; returns (result dict, check readings). `size`
    overrides the workload's (n, nz), for the tests on the CPU."""
    import torch

    from cfdbench.reference import judge

    cell = make_cell(spec, device, size)
    cfg, wl, dims, on_card = spec.config, spec.workload, cell.dims, cell.on_card
    parts = {"compile_s": cell.compile_s}
    mesh_build_s = cell.mesh_build_s
    if dims is None:
        parts.update(mesh_file_s=cell.mesh_file_s, mesh_file_bytes=cell.mesh_file_bytes)
        log(f"kernels {parts['compile_s']} s; mesh file in {cell.mesh_file_s:.2f} s; "
            f"{cell.mesh.n_cells} cells read and compiled in {mesh_build_s:.2f} s")
    else:
        log(f"kernels {parts['compile_s']} s; mesh {dims} built in {mesh_build_s:.2f} s")
    C, value_bytes = cell.mesh.n_cells, cell.dtype.itemsize
    s0 = cell.start(seed)
    solve = cell.solve

    # Warm-up at the cell's shapes; the first call is the first iteration
    # the check reads.
    s1, _ = solve(s0, 1)
    w = int(wl["warmup_iterations"])
    _sync(device)
    t = time.perf_counter()
    sw, _ = solve(s1, w)
    _sync(device)
    per_iter = (time.perf_counter() - t) / w
    iterations = max(2, round(seconds / per_iter))
    log(f"warm-up: {w} iterations at {1e3 * per_iter:.1f} ms each; window of {iterations}")

    # The window.
    _sync(device)
    t0 = time.monotonic()
    # Set-up holds the kernel build of a checkout's first run, which
    # setup_parts.compile_s also reports by itself.
    setup_s = t0 - T_START
    sn, history = solve(sw, iterations)
    _sync(device)
    window_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    pc_residuals = [float(x) for h in history for x in h.pc_residual.reshape(-1).tolist()]
    failed = int(sum(int(torch.sum(h.diverged)) for h in history))

    log(f"window: {iterations} iterations in {window_s:.3f} s, peak {peak / GIB:.2f} GiB")
    traces = None
    if trace:
        from cfdbench.trace import traced

        k = int(wl["trace_iterations"])
        one = traced(lambda: solve(sn, 1), on_card)
        more = traced(lambda: solve(sn, 1 + k), on_card)
        traces = (more.minus(one), more, k)

    # The check's two blocks of single iterations, in the reference's
    # layout; then the reference, after the program's mesh and state are
    # freed.
    layout = cell.layout()
    layout_gap, layout_limit = getattr(layout, "gap", None), getattr(layout, "limit", None)
    blocks = [
        [layout.state(x) for x in [s0] + chain(solve, s1, judge.BLOCK - 1)[0]],
        [layout.state(x) for x in chain(solve, sn, judge.BLOCK)[0]],
    ]
    _sync(device)
    box = cell.box()
    del cell, solve, s0, s1, sw, sn, history, layout
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    log("program freed; reference")
    prm = judge.params(cfg)
    mod = judge.coupling(cfg["reference"]["module"])
    readings = judge.worst(*([judge.judge(box, prm, mod, a, b) for a, b in zip(s, s[1:])] for s in blocks))
    log("reference done")
    limits = dict(wl["limits"])
    if dims is None:
        # The correspondence of cells and faces, checked, never assumed.
        readings["layout"], limits["layout"] = layout_gap, layout_limit
    correct = all(readings[k] <= limits[k] for k in readings) and failed == 0
    check = {k: {"value": readings[k], "limit": limits[k]} for k in readings}

    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": 1, "memory_peak_bytes": int(peak)}
    unit = units(spec)
    result = {"correct": bool(correct), "attempted": iterations, "failed": failed}
    if not trace:
        values = {"iters_per_s": iterations / window_s, "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        result["metrics"] = {
            m: {"value": values[m], "unit": unit[m]} for m in end_to_end_names(spec)
        }
    else:
        sub, more, k = traces
        ctx = MetricContext(sub, k, dims, C, value_bytes, pc_residuals, mesh_build_s)
        metrics = {}
        for m in per_layer_names(spec):
            value = importlib.import_module(f"cfdbench.metrics.{m}").read(ctx)
            if value is not None:
                metrics[m] = {"value": value, "unit": unit[m]}
        result["metrics"] = metrics
        dev["busy_s"] = more.busy_s
        dev["window_s"] = more.window_s
        result["breakdown"] = {"device_ops": more.top_ops(), "idle_gaps": more.top_gaps()}
    result["device"] = dev
    result["setup_parts"] = dict(parts, mesh_build_s=mesh_build_s, window_iterations=iterations, window_s=window_s)
    result["check"] = check
    return result, readings


class MetricContext:
    """What a per-layer metric reads: the trace of k whole iterations,
    the cell's shapes (the box's dims, None on a mesh case; the cell
    count), the window's pressure solve residuals, the mesh build
    seconds and the card's peak HBM rate (peaks.json)."""

    def __init__(self, trace, k, dims, cells, value_bytes, pc_residuals, mesh_build_s):
        self.trace, self.k, self.dims, self.cells = trace, k, dims, cells
        self.value_bytes, self.pc_residuals, self.mesh_build_s = value_bytes, pc_residuals, mesh_build_s
        peaks = json.loads((HERE / "peaks.json").read_text())
        self.hbm_bytes_per_s = float(peaks["hbm_bytes_per_s"])

    def kernel_sum(self, names):
        """(launches, device seconds) of the device ops whose name holds
        one of `names`."""
        n = t = 0
        for key, (count, secs) in self.trace.kernels.items():
            if any(s in key for s in names):
                n += count
                t += secs
        return n, t


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cfdbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)

    import torch

    chips = int(spec.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cfdbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, readings = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"cfdbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
