"""The plain reference held layer by layer to the port on the CPU: the
16^2 flagship cavity (SIMPLE_FC, TVD_DC + UMIST, Rhie-Chow) and the 8^3
MULTIGRID cube (SIMPLE, UD). In float64 the momentum diagonal, u* and
the stored flux agree to rounding, so the reference computes what the
program computes; in float32 they agree within the cells' limits."""

import pytest
import torch

from cfdbench.reference import judge
from cfdbench.run import Cell, load_spec

CASES = [("ghia-3072-ck", (16, 1)), ("cube-256-fm", (8, 8))]


def readings(cell_name, size, dtype, seed=2**31 + 77, iterations=12):
    spec = load_spec(cell_name)
    spec.config = dict(spec.config, dtype=str(dtype).split(".")[1])
    cell = Cell(spec, "cpu", size)
    s0 = cell.start(seed)
    s1, _ = cell.solve(s0, 1)
    sn, _ = cell.solve(s1, iterations)
    sn1, _ = cell.solve(sn, 1)
    layout, box = cell.layout(), cell.box()
    prm = judge.params(spec.config)
    mod = judge.coupling(spec.config["reference"]["module"])
    return spec, [
        judge.judge(box, prm, mod, layout.state(a), layout.state(b))
        for a, b in ((s0, s1), (sn, sn1))
    ]


@pytest.mark.parametrize("cell_name, size", CASES)
def test_layers_agree_in_float64(cell_name, size):
    spec, rows = readings(cell_name, size, torch.float64)
    for nums in rows:
        assert nums["mom_diag"] < 1e-13
        assert nums["u_star"] < 1e-13
        if "flux" in nums:
            assert nums["flux"] < 1e-13
        # The solve's answer, judged by its residual in the reference's
        # own pressure system: a capped Krylov solve or one V-cycle.
        assert 0.0 < nums["p_residual"] < 0.1


@pytest.mark.parametrize("cell_name, size", CASES)
def test_layers_within_limits_in_float32(cell_name, size):
    spec, rows = readings(cell_name, size, torch.float32)
    limits = spec.workload["limits"]
    nums = judge.worst([rows[0]], [rows[1]])
    assert list(nums) == list(limits)
    for k, v in nums.items():
        assert v < limits[k] / 10, (k, v)


def test_face_major_flux_layout():
    """The stored flux of the face-major SIMPLE_FC step ([F], as a cell
    above CK_AUTO_MAX_CELLS keeps it) read through the layout."""
    from orc_tpu_torch.solver import simple

    spec = load_spec("ghia-3072-ck")
    spec.config = dict(spec.config, dtype="float64")
    cell = Cell(spec, "cpu", (16, 1))

    def solve(state, n):
        return simple.solve_steady(
            cell.mesh, cell.table, cell.settings, cell.rho, cell.mu, state=state,
            iterations=n, verbose=False, use_ck=False,
        )

    s0 = cell.start(5)
    s1, _ = solve(s0, 1)
    sn, _ = solve(s1, 8)
    sn1, _ = solve(sn, 1)
    assert sn1.flux.ndim == 1
    layout, box = cell.layout(), cell.box()
    prm = judge.params(spec.config)
    mod = judge.coupling("simple_fc")
    for a, b in ((s0, s1), (sn, sn1)):
        nums = judge.judge(box, prm, mod, layout.state(a), layout.state(b))
        assert nums["mom_diag"] < 1e-13 and nums["u_star"] < 1e-13 and nums["flux"] < 1e-13
