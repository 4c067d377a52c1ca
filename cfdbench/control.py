"""The check's readings over many seeds, beside its control's and its
faults', at a cell's own size and in one process (the mesh is built once),
on a box cell or a mesh case alike.

    python3 -m cfdbench.control --workload <cell> --seeds 1,2,3 --iterations N [--program-only] [--bench B.json --files DIR]

For each seed: the program's first judge.BLOCK iterations from the
seeded start and as many after N more (the state a run's window ends
in), judged as a run judges them; then, from the same input states,
- the control: the reference itself computed in bfloat16 and put in
  the program's place (the port's kernels take float32 and float64
  only, so the step below the configuration's float32 is the
  reference's own);
- `unchanged`: a step that returns its state unchanged;
- `noop_solve`: the program with its pressure solve returning its
  initial guess (`noop_pressure_solve`, planted in the program).
One JSON line per seed (with each judged iteration's `p_residual`), then
the largest program reading and the smallest reading of the control and
of each fault, number by number. `--program-only` reads the program
alone. The limits in workloads/<cell>.json are set between them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

from cfdbench.reference import judge
from cfdbench.run import chain, load_spec, log, make_cell


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


def readings(cell, layout, box, prm, mod, seed, iterations, program_only=False):
    """One seed's row: the program's numbers and each block's
    `p_residual` readings, then the control's and the faults' numbers
    from the program's own input states."""
    s0 = cell.start(seed)
    s1, h1 = cell.solve(s0, 1)
    rest, _ = chain(cell.solve, s1, judge.BLOCK - 1)
    sn, _ = cell.solve(s1, iterations)
    last, hl = chain(cell.solve, sn, judge.BLOCK)
    inputs = ([s0] + rest[:-1], last[:-1])
    states = [[layout.state(x) for x in [s0] + rest], [layout.state(x) for x in last]]
    del rest, last

    def blocks(out):
        """Each block's readings of the outputs `out(a, x)` from its input
        states (a in the reference's layout, x the program's)."""
        return [
            [judge.judge(box, prm, mod, st[i], out(st[i], x)) for i, x in enumerate(xs)]
            for st, xs in zip(states, inputs)
        ]

    program = [[judge.judge(box, prm, mod, a, b) for a, b in zip(st, st[1:])] for st in states]
    row = dict(
        seed=seed,
        program=judge.worst(*program),
        p_residuals=[[r["p_residual"] for r in b] for b in program],
        first=dict(program[0][0], **_claimed(h1)), last=dict(program[1][0], **_claimed(hl[0])),
    )
    if program_only:
        return row

    def noop(a, x):
        with noop_pressure_solve():
            return layout.state(cell.solve(x, 1)[0])

    row["control"] = judge.worst(*blocks(lambda a, x: judge.control(box, prm, mod, a)))
    row["unchanged"] = judge.worst(*blocks(lambda a, x: a))
    row["noop_solve"] = judge.worst(*blocks(noop))
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m cfdbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--iterations", type=int, required=True)
    ap.add_argument("--program-only", action="store_true", help="the program's readings alone")
    ap.add_argument("--bench", type=Path, default=None, help="a BENCHMARK.json other than the checkout's")
    ap.add_argument("--files", type=Path, default=None, help="the folder of its configs/ and workloads/")
    args = ap.parse_args(argv)
    spec = load_spec(args.workload, bench_path=args.bench, files=args.files)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = make_cell(spec, device)
    log(f"mesh of {cell.mesh.n_cells} cells built in {cell.mesh_build_s:.2f} s on {device}")
    layout, box = cell.layout(), cell.box()
    prm = judge.params(spec.config)
    mod = judge.coupling(spec.config["reference"]["module"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(cell, layout, box, prm, mod, seed, args.iterations, args.program_only)
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = list(rows[0]["program"])
    summary = {"workload": args.workload, "seeds": len(rows)}
    summary["program_max"] = {k: max(r["program"][k] for r in rows) for k in keys}
    for name in ("control", "unchanged", "noop_solve")[: 0 if args.program_only else 3]:
        summary[f"{name}_min"] = {k: min(r[name][k] for r in rows) for k in keys}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
