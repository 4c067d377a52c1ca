"""A run with the timed path broken underneath reads `correct` false,
once for each fault these cells can have: a step that returns its state
unchanged, an answer altered where it is produced, and a pressure solve
that returns its initial guess. These runs skip the harness's look for
a card and drive the rest of a run on the CPU at a small size. The
control, the reference itself in bfloat16 put in the program's place,
fails the check too; on the card (marked gpu) it does so at a size a
test run can hold."""

import dataclasses

import pytest
import torch

from cfdbench import control, run
from cfdbench.reference import judge

CASES = [("ghia-3072-ck", (16, 1)), ("cube-256-fm", (8, 8))]


def broken(monkeypatch, fault):
    from orc_tpu_torch.solver import simple

    real = simple.solve_steady

    def solve_steady(mesh, table, settings, rho, mu, state=None, **kw):
        out, history = real(mesh, table, settings, rho, mu, state=state, **kw)
        return fault(state, out), history

    monkeypatch.setattr(simple, "solve_steady", solve_steady)


def unchanged(state_in, state_out):
    return state_in


def altered(state_in, state_out):
    vel = state_out.vel.clone()
    vel[vel.shape[0] // 3, 0] += 1e-3  # one cell's u, a thousandth of the lid speed
    return dataclasses.replace(state_out, vel=vel)


@pytest.mark.parametrize("cell_name, size", CASES)
def test_sound_run_is_correct(cell_name, size):
    result, _ = run.run_cell(run.load_spec(cell_name), 2**31 + 3, 0.3, False, device="cpu", size=size)
    assert result["correct"] is True
    assert list(result)[-1] == "check"


def noop_solve(monkeypatch):
    from orc_tpu_torch.solver import simple

    monkeypatch.setattr(simple, "_solve_p_prime", control.noop_p_solve(simple._solve_p_prime))


@pytest.mark.parametrize(
    "plant",
    [lambda mp: broken(mp, unchanged), lambda mp: broken(mp, altered), noop_solve],
    ids=["unchanged", "altered", "noop_solve"],
)
@pytest.mark.parametrize("cell_name, size", CASES)
def test_broken_run_is_not_correct(monkeypatch, cell_name, size, plant):
    plant(monkeypatch)
    result, readings = run.run_cell(run.load_spec(cell_name), 2**31 + 5, 0.3, False, device="cpu", size=size)
    assert result["correct"] is False, readings


def control_readings(cell_name, size, seeds, iterations, device):
    spec = run.load_spec(cell_name)
    cell = run.Cell(spec, device, size)
    layout, box = cell.layout(), cell.box()
    prm = judge.params(spec.config)
    mod = judge.coupling(spec.config["reference"]["module"])
    return spec, [control.readings(cell, layout, box, prm, mod, s, iterations) for s in seeds]


def assert_control_fails(spec, rows):
    limits = spec.workload["limits"]
    for row in rows:
        assert all(row["program"][k] <= limits[k] for k in limits), row["program"]
        assert any(row["control"][k] > limits[k] for k in limits), row["control"]
        assert any(row["unchanged"][k] > limits[k] for k in limits), row["unchanged"]
        assert row["noop_solve"]["p_residual_first"] > limits["p_residual_first"], row["noop_solve"]


@pytest.mark.parametrize("cell_name, size", CASES)
def test_control_fails_on_cpu(cell_name, size):
    assert_control_fails(*control_readings(cell_name, size, [11, 2**31 + 12], 10, "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name, size", [("ghia-3072-ck", (1024, 1)), ("cube-256-fm", (64, 64))])
def test_control_fails_on_card(cell_name, size):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read on the card at its own sizes")
    assert_control_fails(*control_readings(cell_name, size, [21, 22, 2**31 + 23], 30, "cuda"))
