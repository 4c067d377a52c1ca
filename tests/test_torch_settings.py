"""Port settings (orc_tpu_torch/utils/settings.py) against orc_tpu's:
the same enums, values, defaults and resolution rules."""

import dataclasses
import enum
import itertools

import numpy as np
import pytest
import torch

from torch_parity import to_jax_settings

import jax.numpy as jnp
from orc_tpu.utils import settings as jset

from orc_tpu_torch.utils import settings as tset

ENUMS = sorted(
    name
    for name, obj in vars(jset).items()
    if isinstance(obj, type) and issubclass(obj, enum.Enum)
)


@pytest.mark.parametrize("name", ENUMS)
def test_enum_members_equal(name):
    j, t = getattr(jset, name), getattr(tset, name)
    assert [(m.name, m.value) for m in j] == [(m.name, m.value) for m in t]


@pytest.mark.parametrize("cls", ["MatrixSolverSettings", "NumericalSettings"])
def test_defaults_equal(cls):
    j, t = getattr(jset, cls)(), getattr(tset, cls)()
    jf = [f.name for f in dataclasses.fields(j)]
    assert jf == [f.name for f in dataclasses.fields(t)]
    for name in jf:
        a, b = getattr(j, name), getattr(t, name)
        if dataclasses.is_dataclass(a):
            assert to_jax_settings(b) == a, name
        elif isinstance(a, enum.Enum):
            assert (type(a).__name__, a.value) == (type(b).__name__, b.value)
        else:
            assert a == b, name


def _grid():
    P, R, V, S = (
        tset.PressureVelocityCoupling,
        tset.RelaxationMode,
        tset.VelocityInterpolation,
        tset.SolutionMethod,
    )
    for coupling, relax, vi, solver, mom_it, mom_thr in itertools.product(
        P, R, V, S, (6, None), (0.1, None)
    ):
        yield tset.NumericalSettings(
            pressure_velocity_coupling=coupling,
            relaxation_mode=relax,
            velocity_interpolation=vi,
            matrix_solver=tset.MatrixSolverSettings(
                solver_type=solver,
                momentum_iterations=mom_it,
                momentum_relative_threshold=mom_thr,
            ),
        )


def test_resolution_rules_agree_on_grid():
    """resolved_coupling(), momentum_matrix_solver() and
    resolved_fc_flux_relaxation() over couplings x relaxation modes x
    face velocities x solvers x momentum-solver options."""
    n = 0
    for t in _grid():
        j = to_jax_settings(t)
        assert t.resolved_coupling().value == j.resolved_coupling().value
        assert to_jax_settings(t.momentum_matrix_solver()) == (
            j.momentum_matrix_solver()
        )
        assert t.resolved_fc_flux_relaxation() == j.resolved_fc_flux_relaxation()
        n += 1
    assert n == 3 * 2 * 4 * 5 * 2 * 2


@pytest.mark.parametrize("name", ["tvd_lud", "tvd_quick", "tvd_umist"])
def test_tvd_limiters_equal(name):
    r = np.linspace(-3.0, 5.0, 81)
    a = getattr(jset, name)(jnp.asarray(r))
    b = getattr(tset, name)(torch.tensor(r, dtype=torch.float64))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_package_exports_every_name_of_orc_tpu():
    """Every name orc_tpu exports (orc_tpu.__all__: the settings enums,
    the TVD presets, the mesh entry points) is exported by the port."""
    import orc_tpu
    import orc_tpu_torch

    assert set(orc_tpu.__all__) <= set(orc_tpu_torch.__all__)
    for name in ("TVD_LUD", "TVD_QUICK", "TVD_UMIST"):
        assert getattr(orc_tpu_torch, name) == getattr(tset, name)
