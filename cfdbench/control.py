"""The check's readings over many seeds, beside its control's and its
faults', at a cell's own size and in one process (the mesh is built once).

    python3 -m cfdbench.control --workload <cell> --seeds 1,2,3 --iterations N

For each seed: the program's first iteration from the seeded start and
one iteration after N more (the state a run's window ends in), judged
as a run judges them; then, on the same two states,
- the control: the reference itself computed in bfloat16 and put in
  the program's place (the port's kernels take float32 and float64
  only, so the step below the configuration's float32 is the
  reference's own);
- `unchanged`: a step that returns its state unchanged;
- `noop_solve`: the program with its pressure solve returning its
  initial guess (`noop_pressure_solve`, planted in the program).
One JSON line per seed, then the largest program reading and the
smallest reading of the control and of each fault, number by number.
The limits in workloads/<cell>.json are set between them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from cfdbench.reference import judge
from cfdbench.run import Cell, load_spec, log


def noop_p_solve(real):
    """The program's pressure solve (solver/simple._solve_p_prime)
    made to return its initial guess: zero for SIMPLE's p', the warm
    start p for SIMPLE_FC. The solve still runs, so its counts stay."""

    def solve(Pmat, b_p, p, settings, active, comm, solver_extras, maybe_singular, x0=None):
        sol, info = real(Pmat, b_p, p, settings, active, comm, solver_extras, maybe_singular, x0=x0)
        return (torch.zeros_like(sol) if x0 is None else x0.clone()), info

    return solve


@contextlib.contextmanager
def noop_pressure_solve():
    from orc_tpu_torch.solver import simple

    real = simple._solve_p_prime
    simple._solve_p_prime = noop_p_solve(real)
    try:
        yield
    finally:
        simple._solve_p_prime = real


def _claimed(history):
    """The program's own count and residual of the pressure solve."""
    h = history[-1]
    return dict(pc_iters=int(h.pc_iters[-1]), pc_residual=float(h.pc_residual[-1]))


def readings(cell, layout, box, prm, mod, seed, iterations):
    s0 = cell.start(seed)
    s1, h1 = cell.solve(s0, 1)
    sn, _ = cell.solve(s1, iterations)
    sn1, hn1 = cell.solve(sn, 1)
    with noop_pressure_solve():
        z1, _ = cell.solve(s0, 1)
        zn1, _ = cell.solve(sn, 1)
    a, b = layout.state(s0), layout.state(s1)
    c, d = layout.state(sn), layout.state(sn1)
    first, last = judge.judge(box, prm, mod, a, b), judge.judge(box, prm, mod, c, d)

    def of(out_a, out_c):
        return judge.worst(judge.judge(box, prm, mod, a, out_a), judge.judge(box, prm, mod, c, out_c))

    return dict(
        seed=seed,
        program=judge.worst(first, last),
        control=of(judge.control(box, prm, mod, a), judge.control(box, prm, mod, c)),
        unchanged=of(a, c),
        noop_solve=of(layout.state(z1), layout.state(zn1)),
        first=dict(first, **_claimed(h1)), last=dict(last, **_claimed(hn1)),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m cfdbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--iterations", type=int, required=True)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = Cell(spec, device)
    log(f"mesh {cell.dims} built in {cell.mesh_build_s:.2f} s on {device}")
    layout, box = cell.layout(), cell.box()
    prm = judge.params(spec.config)
    mod = judge.coupling(spec.config["reference"]["module"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(cell, layout, box, prm, mod, seed, args.iterations)
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = list(rows[0]["program"])
    summary = {"workload": args.workload, "seeds": len(rows)}
    summary["program_max"] = {k: max(r["program"][k] for r in rows) for k in keys}
    for name in ("control", "unchanged", "noop_solve"):
        summary[f"{name}_min"] = {k: min(r[name][k] for r in rows) for k in keys}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
