"""The face-major steps as a whole: orc_tpu_torch's `simple_step`,
`simple_step_fc` and the face-major branch of `solve_transient` against
orc_tpu's on the CPU (float64), and the rule by which `solve_steady`
picks a step.

- SIMPLE per iteration, use_ck=False in both packages: bench.py's
  couette on the 128x64 box (CD1 + SecondOrder + Rhie-Chow, explicit
  relaxation, BiCGSTAB(50)), 20 iterations, and the 16^2 cavity with
  solve_cavity's numerics, 20 iterations: every StepMetrics field at
  rtol 1e-6 (absolute floor 1e-12 x the field's largest magnitude),
  equal mom_iters / pc_iters, final fields to 1e-8 of scale.
- SIMPLE_FC per iteration with a Jacobi(50) pressure solve (the FC
  pressure BiCGSTAB is chaotic in roundoff, ROADMAP Queue 3): the FC
  couette 32x16 and the flagship 16^2 cavity, as above, the stored [F]
  flux included; and FC against the parity loop on the 12^2 cavity under
  Rhie-Chow (tests/test_fc.py's converged-field check): the parity loop
  reaches vel_corr < 1e-12 at iteration 458 (FC at 156; at 400 the
  fields still differ by 3.1e-11), so both run 600 iterations and agree
  to 1e-12 (measured 5.4e-15).
- solve_transient face-major, both couplings, every step at rtol 1e-6.
- save_history writes orc_tpu's npz: the same names and arrays.
- The port's (c,k) step against its face-major step (tests/test_ck.py's
  pattern): equal diffusion systems (rtol 1e-13) and fields after 25
  iterations within rtol 3e-5.
- The step rule: CK_AUTO_MAX_CELLS read from ORC_TPU_CK_MAX_CELLS;
  "auto" above it runs the face-major step, bitwise equal to
  use_ck=False.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import np_, to_jax_settings

from orc_tpu.models.cavity import cavity_case as j_cavity
from orc_tpu.models.channel_flow import (
    ChannelFlowParameters as JParams,
    couette_case as j_couette,
)
from orc_tpu.solver import simple as js
from orc_tpu.solver import transient as jt

from orc_tpu_torch.interop import flow_state_from_numpy
from orc_tpu_torch.models.cavity import (
    cavity_case as t_cavity,
    default_settings,
    flagship_settings,
)
from orc_tpu_torch.models.channel_flow import (
    ChannelFlowParameters as TParams,
    couette_case as t_couette,
)
from orc_tpu_torch.solver import simple as ts
from orc_tpu_torch.solver import transient as tt
from orc_tpu_torch.utils import settings as tset

REPO = Path(__file__).resolve().parent.parent

BICGSTAB_50 = tset.MatrixSolverSettings(
    solver_type=tset.SolutionMethod.BICGSTAB,
    iterations=50,
    preconditioner=tset.PreconditionMethod.JACOBI,
)
JACOBI_50 = tset.MatrixSolverSettings(
    solver_type=tset.SolutionMethod.JACOBI,
    iterations=50,
    preconditioner=tset.PreconditionMethod.JACOBI,
)
#: bench.py's numerics: the reference defaults, explicit relaxation.
BENCH = tset.NumericalSettings(matrix_solver=BICGSTAB_50)
#: The FC residual fixture's numerics (tests/test_torch_fc.py FIXTURE_FC)
#: with the Jacobi(50) pressure solve.
FC_COUETTE = tset.NumericalSettings(
    momentum=tset.MomentumScheme.CD1,
    pressure_velocity_coupling=tset.PressureVelocityCoupling.SIMPLE_FC,
    velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
    pressure_interpolation=tset.PressureInterpolation.SECOND_ORDER,
    relaxation_mode=tset.RelaxationMode.IMPLICIT,
    momentum_relaxation=0.7,
    pressure_relaxation=0.3,
    matrix_solver=JACOBI_50,
)
COUETTE_KW = dict(top_wall_velocity=5e-4, dp_dx=10.0)


def _case(name):
    """(jax mesh, table), (torch mesh, table), settings, rho, mu, iters."""
    if name == "couette":
        return (
            j_couette(128, 64, params=JParams(**COUETTE_KW)),
            t_couette(128, 64, params=TParams(**COUETTE_KW), device="cpu"),
            BENCH.replace(matrix_solver=JACOBI_50), 1000.0, 0.001, 20,
        )
    if name == "couette-32":
        return (
            j_couette(32, 16, params=JParams(**COUETTE_KW)),
            t_couette(32, 16, params=TParams(**COUETTE_KW), device="cpu"),
            BENCH, 1000.0, 0.001, 200,
        )
    if name == "fc-couette":
        return (
            j_couette(32, 16, params=JParams(**COUETTE_KW)),
            t_couette(32, 16, params=TParams(**COUETTE_KW), device="cpu"),
            FC_COUETTE, 1000.0, 0.001, 40,
        )
    settings = (
        flagship_settings().replace(matrix_solver=JACOBI_50)
        if name == "fc-cavity" else default_settings()
    )
    return (
        j_cavity(n=16), t_cavity(n=16, device="cpu"), settings, 1.0, 0.01, 20,
    )


def _run(name, use_ck=False):
    (mj, tj), (mt, tt_), settings, rho, mu, iterations = _case(name)
    kw = dict(iterations=iterations, reporting_interval=iterations, verbose=False)
    sj, hj = js.solve_steady(mj, tj, to_jax_settings(settings), rho, mu, use_ck=use_ck, **kw)
    st, ht = ts.solve_steady(mt, tt_, settings, rho, mu, use_ck=use_ck, **kw)
    return (sj, js.stack_history(hj)), (st, ts.stack_history(ht))


def _scale_close(actual, desired, rel, name):
    d = np.asarray(desired, dtype=np.float64)
    np.testing.assert_allclose(
        np.asarray(actual, dtype=np.float64), d, rtol=rel,
        atol=rel * float(np.max(np.abs(d))), err_msg=name,
    )


def _assert_metrics_track(hj, ht):
    for f in hj._fields:
        a, b = np.asarray(getattr(hj, f)), np_(getattr(ht, f))
        assert a.shape == b.shape, f
        if f in ("mom_iters", "pc_iters", "diverged"):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            d = a.astype(np.float64)
            np.testing.assert_allclose(
                b, d, rtol=1e-6, atol=1e-12 * float(np.max(np.abs(d))), err_msg=f
            )


@pytest.mark.parametrize(
    "name", ["couette", "couette-32", "cavity", "fc-couette", "fc-cavity"]
)
def test_face_major_step_tracks_orc_tpu(name):
    (sj, hj), (st, ht) = _run(name)
    _assert_metrics_track(hj, ht)
    fields = ("vel", "p", "flux") if name.startswith("fc") else ("vel", "p")
    for f in fields:
        _scale_close(np_(getattr(st, f)), np.asarray(getattr(sj, f)), 1e-8, f)
    if name.startswith("fc"):
        assert st.flux.ndim == 1  # one value per face
    assert not ht.diverged.any()


def test_face_major_fc_continues_from_orc_tpu_state():
    """A face-major SIMPLE_FC state of orc_tpu, its [F] flux carried over
    with interop, continues in the port along orc_tpu's trajectory."""
    (mj, tj), (mt, tt_), settings, rho, mu, _ = _case("fc-cavity")
    kw = dict(iterations=5, reporting_interval=5, verbose=False, use_ck=False)
    js_settings = to_jax_settings(settings)
    sj, _ = js.solve_steady(mj, tj, js_settings, rho, mu, **kw)
    carried = flow_state_from_numpy(
        np.asarray(sj.vel), np.asarray(sj.p), np.asarray(sj.mom_diag),
        np.asarray(sj.flux), device="cpu",
    )
    sj2, hj = js.solve_steady(mj, tj, js_settings, rho, mu, state=sj, **kw)
    st2, ht = ts.solve_steady(mt, tt_, settings, rho, mu, state=carried, **kw)
    _assert_metrics_track(js.stack_history(hj), ts.stack_history(ht))
    _scale_close(np_(st2.flux), np.asarray(sj2.flux), 1e-8, "flux")


def test_fc_matches_parity_converged_field():
    """tests/test_fc.py's check on the face-major step: under Rhie-Chow
    the FC pressure-equation coefficient is the Rhie-Chow damping
    coefficient, so SIMPLE_FC and the parity loop converge to the same
    discrete solution (12^2 cavity, 600 iterations each, both
    machine-converged)."""
    fields = {}
    for coupling, pr in (("SIMPLE", 0.1), ("SIMPLE_FC", 0.3)):
        mt, tt_ = t_cavity(n=12, lid_velocity=1.0, device="cpu")
        s = tset.NumericalSettings(
            momentum=tset.MomentumScheme.UD,
            pressure_velocity_coupling=tset.PressureVelocityCoupling[coupling],
            pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
            velocity_interpolation=tset.VelocityInterpolation.RHIE_CHOW,
            relaxation_mode=tset.RelaxationMode.IMPLICIT,
            momentum_relaxation=0.7,
            pressure_relaxation=pr,
            matrix_solver=dataclasses.replace(BICGSTAB_50, iterations=60),
        )
        st, hist = ts.solve_steady(
            mt, tt_, s, 1.0, 0.01, iterations=600, reporting_interval=600,
            verbose=False, use_ck=False,
        )
        assert (ts.stack_history(hist).vel_corr_norm < 1e-12).any(), coupling
        fields[coupling] = (np_(st.vel), np_(st.p))
    (v_s, p_s), (v_f, p_f) = fields.values()
    np.testing.assert_allclose(v_s, v_f, rtol=0, atol=1e-12)
    # p is gauge on the all-wall cavity: compare zero-mean fields.
    np.testing.assert_allclose(p_s - p_s.mean(), p_f - p_f.mean(), rtol=0, atol=1e-12)


# --- transient ----------------------------------------------------------


@pytest.mark.parametrize("coupling", ["SIMPLE", "SIMPLE_FC"])
def test_face_major_transient_tracks_orc_tpu(coupling):
    """Both couplings of the face-major branch (use_ck=False), each
    step's last inner iteration at rtol 1e-6: the 16^2 cavity from rest
    under solve_cavity's numerics (parity) and the flagship numerics
    with a Jacobi(50) pressure solve (SIMPLE_FC)."""
    settings = (
        default_settings() if coupling == "SIMPLE"
        else flagship_settings().replace(matrix_solver=JACOBI_50)
    )
    assert settings.resolved_coupling().name == coupling
    run = dict(dt=0.05, n_steps=4, inner_iterations=5, verbose=False, use_ck=False)
    mj, tj = j_cavity(n=16)
    sj, hj = jt.solve_transient(mj, tj, to_jax_settings(settings), 1.0, 0.01, **run)
    mt, tt_ = t_cavity(n=16, device="cpu")
    st, ht = tt.solve_transient(mt, tt_, settings, 1.0, 0.01, **run)
    _assert_metrics_track(hj, ht)
    _scale_close(np_(st.vel), np.asarray(sj.vel), 1e-8, "vel")
    if coupling == "SIMPLE_FC":
        assert st.flux.shape == (mt.n_faces,)
        _scale_close(np_(st.flux), np.asarray(sj.flux), 1e-8, "flux")


# --- save_history ---------------------------------------------------------


def test_save_history_matches_orc_tpu(tmp_path):
    (mj, tj), (mt, tt_), settings, rho, mu, _ = _case("cavity")
    kw = dict(iterations=6, reporting_interval=4, verbose=False, use_ck=False)
    _, hj = js.solve_steady(mj, tj, to_jax_settings(settings), rho, mu, **kw)
    _, ht = ts.solve_steady(mt, tt_, settings, rho, mu, **kw)
    js.save_history(tmp_path / "j.npz", hj)
    ts.save_history(tmp_path / "t.npz", ht)
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert list(a.files) == list(b.files) == [f.name for f in dataclasses.fields(ts.StepMetrics)]
    for f in a.files:
        assert a[f].shape == b[f].shape, f
        if a[f].dtype.kind in "biu":
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
        else:
            np.testing.assert_allclose(
                b[f], a[f], rtol=1e-6, atol=1e-12 * float(np.max(np.abs(a[f]))), err_msg=f
            )


def test_step_metrics_has_orc_tpu_fields_in_order():
    assert [f.name for f in dataclasses.fields(ts.StepMetrics)] == list(js.StepMetrics._fields)


# --- (c,k) against face-major in the port --------------------------------


CK_SCHEMES = {
    "default": default_settings(),
    "refdef-rc": BENCH.replace(
        relaxation_mode=tset.RelaxationMode.IMPLICIT,
        pressure_velocity_coupling=tset.PressureVelocityCoupling.SIMPLE,
        momentum_relaxation=0.7, pressure_relaxation=0.1,
    ),
    "lsq-tvd_dc": default_settings().replace(
        momentum=tset.MomentumScheme.TVD_DC, tvd_psi=tset.tvd_umist,
        gradient_reconstruction=tset.GradientReconstruction.LEAST_SQUARES,
    ),
    # The FC pressure BiCGSTAB is chaotic in roundoff (ROADMAP Queue 3).
    "fc": flagship_settings().replace(matrix_solver=JACOBI_50),
}


@pytest.mark.parametrize("scheme", sorted(CK_SCHEMES))
def test_ck_step_matches_face_major(scheme):
    from orc_tpu_torch.ops.assembly import diffusion_system
    from orc_tpu_torch.ops.ck_ops import build_ck_geometry, ck_bc, ck_diffusion
    from orc_tpu_torch.ops.fields import device_bc, face_bc

    settings = CK_SCHEMES[scheme]
    mesh, table = t_cavity(n=16, device="cpu")
    zc, zs, zv = device_bc(table, dtype=mesh.dtype, device="cpu")
    diff = diffusion_system(mesh, face_bc(mesh, zc, zs, zv), 0.01)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    ckd = ck_diffusion(mesh, ck, ck_bc(ck, zc, zs, zv), 0.01)
    np.testing.assert_allclose(np_(ckd[0]), np_(diff.diag), rtol=1e-13)
    np.testing.assert_allclose(np_(ckd[2]), np_(diff.b), rtol=1e-13, atol=1e-20)

    rng = np.random.default_rng(0)
    state = ts.initial_state(
        mesh,
        vel=rng.standard_normal((mesh.n_cells, 3)) * 1e-4,
        p=rng.standard_normal(mesh.n_cells) * 1e-3,
    )
    out = {}
    for use_ck in (True, False):
        out[use_ck], _ = ts.solve_steady(
            mesh, table, settings, 1.0, 0.01, state=state, iterations=25,
            reporting_interval=25, verbose=False, use_ck=use_ck,
        )
    for f in ("vel", "p"):
        np.testing.assert_allclose(
            np_(getattr(out[True], f)), np_(getattr(out[False], f)), rtol=3e-5, atol=1e-12
        )


# --- the step rule ------------------------------------------------------


def test_auto_above_the_ceiling_takes_the_face_major_step(monkeypatch):
    mt, tt_ = t_cavity(n=12, device="cpu")
    settings = default_settings()
    kw = dict(iterations=3, reporting_interval=3, verbose=False)
    built = []
    real = ts.build_ck_geometry
    monkeypatch.setattr(ts, "build_ck_geometry", lambda *a: built.append(1) or real(*a))
    monkeypatch.setattr(ts, "CK_AUTO_MAX_CELLS", mt.n_cells - 1)
    sa, ha = ts.solve_steady(mt, tt_, settings, 1.0, 0.01, **kw)
    assert not built
    sf, hf = ts.solve_steady(mt, tt_, settings, 1.0, 0.01, use_ck=False, **kw)
    for f in ("vel", "p", "mom_diag"):
        assert torch.equal(getattr(sa, f), getattr(sf, f)), f
    monkeypatch.setattr(ts, "CK_AUTO_MAX_CELLS", mt.n_cells)
    ts.solve_steady(mt, tt_, settings, 1.0, 0.01, **kw)
    assert built


def test_ceiling_is_read_from_the_environment():
    code = (
        "import orc_tpu_torch.solver.simple as s\n"
        "print(s.CK_AUTO_MAX_CELLS)\n"
    )
    out = {}
    for value in (None, "1234"):
        env = {k: v for k, v in os.environ.items() if k != "ORC_TPU_CK_MAX_CELLS"}
        if value is not None:
            env["ORC_TPU_CK_MAX_CELLS"] = value
        res = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=300,
        )
        assert res.returncode == 0, res.stderr
        out[value] = int(res.stdout.strip())
    assert out == {None: 10_000_000, "1234": 1234}
