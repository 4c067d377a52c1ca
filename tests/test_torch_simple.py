"""The slice as a whole: orc_tpu_torch's steady SIMPLE loop against
orc_tpu's on CPU.

- couette 32x16x1 float64 with bench.py's settings (CD1 + SecondOrder
  + Rhie-Chow, explicit relaxation, BiCGSTAB(50)), 200 iterations;
- cavity 16x16 float64 with solve_cavity's settings (UD +
  LinearWeighted, implicit relaxation, 6-sweep momentum smoother), 20
  iterations;
every StepMetrics field (what scripts/gen_residual_fixture.py pins)
tracks orc_tpu at rtol 1e-6, with an absolute floor of 1e-12 x the
field's largest magnitude for components that are zero up to roundoff
(e.g. the mean of v in a closed cavity); mom_iters and pc_iters are
equal; the final fields agree to 1e-8 of their scale.

- cavity 16x16 float32, 10 iterations, exercising the Kahan-compensated
  state (float32 only): fields agree to 1e-4 of their scale and pc_iters
  differ by at most 1, because float32 sums in another order round
  differently.
- cavity 16x16 float64 under forced SIMPLE with implicit relaxation and
  the parity kernels' wider branches: the reference's default numerics
  (CD1 + SecondOrder + Rhie-Chow, scripts/bench_cavity.py with
  ORC_TPU_BENCH_SCHEME=default) and TVD_DC (UMIST, LinearWeighted), 20
  iterations, tracking orc_tpu as above. Each runs twice: through the
  plain (c,k) step, and through the fused-assembly branch of the step
  (the kernel gate opened on the CPU, so the kernels' plain versions
  run), where under `AsmSpec.gg` no plain grad-p pass may run.
"""

import functools

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import DTYPES, np_, to_jax_settings

from orc_tpu.models.cavity import cavity_case as j_cavity
from orc_tpu.models.channel_flow import (
    ChannelFlowParameters as JParams,
    couette_case as j_couette,
)
from orc_tpu.solver import simple as js

from orc_tpu_torch.interop import flow_state_from_numpy
from orc_tpu_torch.models.cavity import cavity_case as t_cavity, default_settings
from orc_tpu_torch.models.channel_flow import (
    ChannelFlowParameters as TParams,
    couette_case as t_couette,
)
from orc_tpu_torch.solver import simple as ts
from orc_tpu_torch.utils import settings as tset

REPO = Path(__file__).resolve().parent.parent

BENCH_SETTINGS = tset.NumericalSettings(
    matrix_solver=tset.MatrixSolverSettings(
        solver_type=tset.SolutionMethod.BICGSTAB,
        iterations=50,
        preconditioner=tset.PreconditionMethod.JACOBI,
    ),
)


def _case(name, dtype):
    jd, td = DTYPES[dtype]
    if name == "couette":
        kw = dict(top_wall_velocity=5e-4, dp_dx=10.0)
        return (
            j_couette(32, 16, params=JParams(**kw), dtype=jd),
            t_couette(32, 16, params=TParams(**kw), dtype=td, device="cpu"),
            BENCH_SETTINGS, 1000.0, 0.001,
        )
    return (
        j_cavity(n=16, dtype=jd), t_cavity(n=16, dtype=td, device="cpu"),
        default_settings(), 1.0, 1.0 / 100.0,
    )


def _run(name, dtype, iterations, state=None):
    (mj, tj), (mt, tt), settings, rho, mu = _case(name, dtype)
    kw = dict(iterations=iterations, reporting_interval=iterations, verbose=False)
    sj, hj = js.solve_steady(
        mj, tj, to_jax_settings(settings), rho, mu,
        state=js.initial_state(mj) if state is None else state[0], **kw
    )
    st, ht = ts.solve_steady(
        mt, tt, settings, rho, mu,
        state=ts.initial_state(mt) if state is None else state[1], **kw
    )
    return (sj, js.stack_history(hj)), (st, ts.stack_history(ht))


def _scale_close(actual, desired, rel, name):
    d = np.asarray(desired, dtype=np.float64)
    np.testing.assert_allclose(
        np.asarray(actual, dtype=np.float64), d, rtol=rel,
        atol=rel * float(np.max(np.abs(d))), err_msg=name,
    )


def _assert_tracks(jres, tres):
    (sj, hj), (st, ht) = jres, tres
    for f in hj._fields:
        a, b = np.asarray(getattr(hj, f)), getattr(ht, f)
        assert a.shape == b.shape, f
        if f in ("mom_iters", "pc_iters", "diverged"):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            d = a.astype(np.float64)
            np.testing.assert_allclose(
                b, d, rtol=1e-6, atol=1e-12 * float(np.max(np.abs(d))),
                err_msg=f,
            )
    _scale_close(np_(st.vel), np_(sj.vel), 1e-8, "vel")
    _scale_close(np_(st.p), np_(sj.p), 1e-8, "p")


@pytest.mark.parametrize("name,iterations", [("couette", 200), ("cavity", 20)])
def test_slice_tracks_orc_tpu_f64(name, iterations):
    jres, tres = _run(name, "f64", iterations)
    _assert_tracks(jres, tres)
    assert not tres[1].diverged.any()


def test_cavity_f32_compensated_state():
    (sj, hj), (st, ht) = _run("cavity", "f32", 10)
    assert st.vel.dtype == torch.float32
    _scale_close(np_(st.vel), np_(sj.vel), 1e-4, "vel")
    _scale_close(np_(st.p), np_(sj.p), 1e-4, "p")
    assert np.max(np.abs(ht.pc_iters - np.asarray(hj.pc_iters))) <= 1
    np.testing.assert_array_equal(ht.mom_iters, np.asarray(hj.mom_iters))


def test_continue_from_orc_tpu_state():
    """A state produced by orc_tpu, carried over with interop, continues
    in the port along orc_tpu's own trajectory."""
    (sj, _), _ = _run("cavity", "f64", 5)
    carried = flow_state_from_numpy(
        np.asarray(sj.vel), np.asarray(sj.p), np.asarray(sj.mom_diag),
        device="cpu",
    )
    jres, tres = _run("cavity", "f64", 5, state=(sj, carried))
    _assert_tracks(jres, tres)


def test_unported_paths_raise():
    """Gauss-Seidel solves, which this test once saw raise, run on both
    steps and track orc_tpu for 5 iterations on the 16^2 cavity (the
    greedy colouring built once per run); node-based Green-Gauss and the
    face-major step run in tests/test_torch_nodes.py and
    tests/test_torch_face_major_steps.py."""
    (mj, tj), (mt, tt), settings, rho, mu = _case("cavity", "f64")
    gs = settings.replace(
        matrix_solver=tset.MatrixSolverSettings(
            solver_type=tset.SolutionMethod.GAUSS_SEIDEL
        )
    )
    kw = dict(iterations=5, reporting_interval=5, verbose=False)
    for use_ck in ("auto", False):
        sj, hj = js.solve_steady(mj, tj, to_jax_settings(gs), rho, mu, use_ck=use_ck, **kw)
        st, ht = ts.solve_steady(mt, tt, gs, rho, mu, use_ck=use_ck, **kw)
        _assert_tracks((sj, js.stack_history(hj)), (st, ts.stack_history(ht)))


def _forced_simple(momentum, vi, pi, **kw):
    return tset.NumericalSettings(
        momentum=momentum,
        pressure_velocity_coupling=tset.PressureVelocityCoupling.SIMPLE,
        velocity_interpolation=vi,
        pressure_interpolation=pi,
        matrix_solver=BENCH_SETTINGS.matrix_solver,
        pressure_relaxation=0.1,
        momentum_relaxation=0.7,
        relaxation_mode=tset.RelaxationMode.IMPLICIT,
        **kw,
    )


#: Forced-SIMPLE cavity numerics of the parity kernels' wider branches.
PARITY_BRANCHES = {
    "reference-default": _forced_simple(
        tset.MomentumScheme.CD1, tset.VelocityInterpolation.RHIE_CHOW,
        tset.PressureInterpolation.SECOND_ORDER,
    ),
    "tvd_dc": _forced_simple(
        tset.MomentumScheme.TVD_DC, tset.VelocityInterpolation.LINEAR_WEIGHTED,
        tset.PressureInterpolation.LINEAR_WEIGHTED, tvd_psi=tset.tvd_umist,
    ),
}


@functools.cache
def _orc_tpu_branch_run(name):
    mj, tj = j_cavity(n=16)
    sj, hj = js.solve_steady(
        mj, tj, to_jax_settings(PARITY_BRANCHES[name]), 1.0, 0.01,
        iterations=20, reporting_interval=20, verbose=False,
    )
    return sj, js.stack_history(hj)


@pytest.mark.parametrize("branch", ["kernel", "plain"])
@pytest.mark.parametrize("name", sorted(PARITY_BRANCHES))
def test_parity_branches_track_orc_tpu(monkeypatch, name, branch):
    settings = PARITY_BRANCHES[name]
    mt, tt = t_cavity(n=16, device="cpu")
    gradient_passes = []
    real_gradient = ts.ck_pressure_gradient

    def counted(*a, **k):
        gradient_passes.append(1)
        return real_gradient(*a, **k)

    monkeypatch.setattr(ts, "ck_pressure_gradient", counted)
    if branch == "kernel":
        monkeypatch.setattr(ts, "_on_cuda", lambda mesh: True)
        from orc_tpu_torch.ops.ck_ops import build_ck_geometry

        ck = build_ck_geometry(mt, len(tt.zone_ids))
        _cols, spec = ts._kernel_asm_spec(mt, tt, settings, ck)
        assert spec.gg == (name == "reference-default")
    st, ht = ts.solve_steady(
        mt, tt, settings, 1.0, 0.01, iterations=20, reporting_interval=20,
        verbose=False,
    )
    _assert_tracks(_orc_tpu_branch_run(name), (st, ts.stack_history(ht)))
    assert not ts.stack_history(ht).diverged.any()
    needs_gradient = name == "reference-default" and branch == "plain"
    assert bool(gradient_passes) == needs_gradient


def test_kernel_gate_is_off_on_cpu():
    (_, _), (mt, tt), settings, _, _ = _case("cavity", "f64")
    from orc_tpu_torch.ops.ck_ops import build_ck_geometry

    ck = build_ck_geometry(mt, len(tt.zone_ids))
    assert ts._kernel_asm_spec(mt, tt, settings, ck) is None


def test_port_runs_without_jax():
    """Importing and running the port, its sharded runtime included,
    loads no jax module."""
    code = (
        "import sys\n"
        "import orc_tpu_torch\n"
        "import orc_tpu_torch.parallel\n"
        "from orc_tpu_torch.models.cavity import solve_cavity\n"
        "solve_cavity(n=8, iterations=2, verbose=False, device='cpu')\n"
        "solve_cavity(n=8, iterations=2, n_devices=2, verbose=False, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'orc_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
