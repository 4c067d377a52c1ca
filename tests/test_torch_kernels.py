"""The port's four kernel modules against orc_tpu's Pallas kernels.

On CPU each wrapper runs its plain torch version; those are held
against the JAX kernels run as orc_tpu's own tests run them (Pallas
interpret mode) and against the XLA formulations they replace:
- shift_spmv vs pallas_spmv.shift_spmv(interpret=True) and the shift
  branch of spmv.ell_spmv;
- fused_jacobi_sweeps vs pallas_smooth._fused_batched(interpret=True)
  (float32) and sweeps_xla (float64), on the offset patterns of
  tests/test_pallas_smooth.py;
- momentum_assembly / pc_assembly vs pallas_assembly's kernels
  (interpret=True) and the ck oracle, UD and CD1, on the cases of
  tests/test_pallas_assembly.py; their Rhie-Chow, SecondOrder, TVD_DC
  and in-kernel Green-Gauss branches vs the interpret-mode kernels
  (float32, rtol 2e-5) and, in float64 at rtol 1e-10, vs orc_tpu's ck
  oracles; the kernel gate vs orc_tpu's `_pallas_asm_spec`;
- fc_momentum_assembly / fc_pc_assembly (SIMPLE_FC) vs pallas_assembly's
  FC kernels (interpret=True, float32, the windows and tolerances of
  orc_tpu's tests/test_pallas_assembly.py: rtol 2e-5) and, in float64 at
  rtol 1e-10, vs orc_tpu's ck oracles (ck_momentum fed with the stored
  flux; fc.ck_flux_h + ck_d_coeffs + ck_fc_pressure_system).
Tolerances: float64 rtol 1e-12 (same arithmetic, only sum order and
FMA contraction may differ); float32 rtol 2e-6 as orc_tpu's smoother
and SpMV tests use. Absolute floors scale with the reference magnitude,
for entries that cancel to roundoff.

The CUDA kernels themselves are checked against these plain versions
on the card by tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from torch_parity import (
    CASES,
    DTYPES,
    both,
    cell_fields,
    np_,
    structured_system,
    to_jax_settings,
)

import jax.numpy as jnp
from orc_tpu.mesh.generate import structured_box_mesh as jbox
from orc_tpu.ops import ck_ops as jck
from orc_tpu.ops import pallas_assembly as jasm
from orc_tpu.ops.fields import device_bc as jdevice_bc
from orc_tpu.ops.pallas_smooth import _fused_batched, sweeps_xla
from orc_tpu.ops.pallas_spmv import shift_spmv as j_shift_spmv
from orc_tpu.ops.spmv import ell_spmv as j_ell_spmv

from orc_tpu_torch.ops import _cuda
from orc_tpu_torch.ops import fused_assembly as tasm
from orc_tpu_torch.ops import ck_ops as tck
from orc_tpu_torch.ops.fields import device_bc as tdevice_bc
from orc_tpu_torch.ops.fused_smooth import fused_jacobi_sweeps
from orc_tpu_torch.ops.shift_spmv import shift_spmv, shift_spmv_plain

TOL = {"f64": 1e-12, "f32": 2e-6}


def _close(actual, desired, rtol, name=""):
    d = np_(desired)
    np.testing.assert_allclose(
        np_(actual), d, rtol=rtol, atol=rtol * float(np.max(np.abs(d))),
        err_msg=name,
    )


# --- kernel 1: shift_spmv ---------------------------------------------


def _box_system(dims, dtype, seed=0):
    """Seeded structured system on an orc_tpu box: off is zero wherever
    a column is not an interior face (the EllMatrix offsets contract)."""
    mesh, _ = jbox(*dims)
    interior = np.asarray(
        mesh.face_interior[mesh.cell_faces] & mesh.cell_face_mask
    )
    C, K = interior.shape
    rng = np.random.default_rng(seed)
    off = rng.standard_normal((C, K)) * interior
    diag = rng.standard_normal(C)
    x = rng.standard_normal((3, C))
    return mesh.neighbor_offsets, diag, off, x


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("dims", [(17, 9, 3), (5, 4, 1), (40, 11, 2)])
def test_shift_spmv_matches_pallas_kernel(dims, dtype):
    offsets, diag, off, x = _box_system(dims, dtype)
    jd, td = DTYPES[dtype]
    y_pal = j_shift_spmv(
        jnp.asarray(diag, jd), jnp.asarray(off, jd), offsets,
        jnp.asarray(x[0], jd), interpret=True,
    )
    y = shift_spmv(
        torch.tensor(diag, dtype=td), torch.tensor(off, dtype=td), offsets,
        torch.tensor(x[0], dtype=td),
    )
    _close(y, y_pal, TOL[dtype])


def test_shift_spmv_multiblock_offsets():
    """Offsets crossing the TPU kernel's lane and block boundaries."""
    C = 128 * 300
    offsets = (-130, -1, 1, 130, 0, 0)
    diag, off, _b, x = structured_system(C, offsets, seed=1)
    y_pal = j_shift_spmv(
        jnp.asarray(diag), jnp.asarray(off), offsets, jnp.asarray(x),
        interpret=True,
    )
    y = shift_spmv(
        torch.tensor(diag), torch.tensor(off), offsets, torch.tensor(x)
    )
    _close(y, y_pal, TOL["f64"])


@pytest.mark.parametrize("form", ["ck", "split"])
def test_shift_spmv_batched_matches_ell_spmv(form):
    """[3,C] right-hand sides over one shared matrix, in the [C,K] and
    the split-column forms, against orc_tpu's XLA shift SpMV."""
    offsets, diag, off, x = _box_system((12, 7, 2), "f64", seed=2)
    y_ref = j_ell_spmv(
        jnp.asarray(diag), jnp.asarray(off), None, jnp.asarray(x), offsets
    )
    toff = torch.tensor(off)
    if form == "split":
        toff = tuple(toff[:, k] for k in range(toff.shape[1]))
    y = shift_spmv(torch.tensor(diag), toff, offsets, torch.tensor(x))
    assert y.shape == (3, diag.shape[0])
    _close(y, y_ref, TOL["f64"])


def _per_row_systems(dims, seeds):
    """One seeded box system per batch row: offsets, diag [B,C], off
    [B,C,K], x [B,C]."""
    systems = [_box_system(dims, "f64", seed=s) for s in seeds]
    offsets = systems[0][0]
    diag = np.stack([d for _o, d, _f, _x in systems])
    off = np.stack([f for _o, _d, f, _x in systems])
    x = np.stack([x[0] for _o, _d, _f, x in systems])
    return offsets, diag, off, x


@pytest.mark.parametrize("form", ["ck", "split"])
@pytest.mark.parametrize("dims", [(12, 7, 2), (9, 5, 1)])
def test_shift_spmv_per_row_matches_ell_spmv(dims, form):
    """Each batch row over its own matrix (diag [3,C], off [3,C,K] or
    K [3,C] columns: the CD2 / TVD momentum systems) against orc_tpu's
    XLA shift SpMV of each row."""
    import jax

    offsets, diag, off, x = _per_row_systems(dims, (3, 4, 5))
    y_ref = jax.vmap(lambda d, o, v: j_ell_spmv(d, o, None, v, offsets))(
        jnp.asarray(diag), jnp.asarray(off), jnp.asarray(x)
    )
    toff = torch.tensor(off)
    if form == "split":
        toff = tuple(toff[..., k] for k in range(toff.shape[-1]))
    y = shift_spmv(torch.tensor(diag), toff, offsets, torch.tensor(x))
    _close(y, y_ref, TOL["f64"])


@pytest.mark.parametrize("split", [False, True], ids=["ck", "split"])
def test_sweeps_per_row_match_xla_loop(split):
    """Six sweeps with one matrix per batch row against orc_tpu's
    sweeps_xla of each row."""
    import jax

    offsets, diag, off, x0 = _per_row_systems((11, 6, 1), (6, 7, 8))
    b = np.random.default_rng(9).standard_normal(x0.shape)
    y_ref = jax.vmap(lambda d, o, bb, xx: sweeps_xla(d, o, offsets, bb, xx, 6, 0.8))(
        *(jnp.asarray(a) for a in (diag, off, b, x0))
    )
    toff = torch.tensor(off)
    if split:
        toff = tuple(toff[..., k] for k in range(toff.shape[-1]))
    y = fused_jacobi_sweeps(
        torch.tensor(diag), toff, offsets, torch.tensor(b), torch.tensor(x0), 6, 0.8
    )
    _close(y, y_ref, TOL["f64"])


def test_cpu_tensors_take_the_plain_version():
    offsets, diag, off, x = _box_system((6, 5, 1), "f64")
    before = shift_spmv.launches
    args = (torch.tensor(diag), torch.tensor(off), offsets, torch.tensor(x))
    assert torch.equal(shift_spmv(*args), shift_spmv_plain(*args))
    assert shift_spmv.launches == before


# --- kernel 4: fused_jacobi_sweeps --------------------------------------

SMOOTH_CASES = [
    ((-40, -1, 1, 40), 1),
    ((-40, -1, 1, 40), 6),
    ((-40, -1, 1, 40, 0, 0), 4),  # 2D mesh with padded K=6 slots
    ((-1600, -40, -1, 1, 40, 1600), 3),  # 3D-like pattern
    ((-130, -1, 1, 130), 5),  # |d| > 128: multi-row halo on the TPU
]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("offsets,sweeps", SMOOTH_CASES)
def test_sweeps_match_pallas_kernel(offsets, sweeps, dtype):
    """float32 against the interpret-mode kernel (the dtype orc_tpu's
    own test uses), float64 against sweeps_xla (the formulation the
    kernel reproduces; interpret-mode compiles cost ~3 s per case)."""
    C = 2100
    jd, td = DTYPES[dtype]
    diag, off, b, x0 = structured_system(C, offsets, B=3, seed=1)
    jdiag, jb, jx0 = (jnp.asarray(a, jd) for a in (diag, b, x0))
    if dtype == "f32":
        cols = tuple(jnp.asarray(off[:, k], jd) for k in range(off.shape[1]))
        y_ref = _fused_batched(
            jdiag, cols, jb, jx0, offsets=offsets, sweeps=sweeps,
            relaxation=0.8, interpret=True,
        )
    else:
        y_ref = sweeps_xla(
            jdiag, jnp.asarray(off, jd), offsets, jb, jx0, sweeps, 0.8
        )
    y = fused_jacobi_sweeps(
        torch.tensor(diag, dtype=td), torch.tensor(off, dtype=td), offsets,
        torch.tensor(b, dtype=td), torch.tensor(x0, dtype=td), sweeps, 0.8,
    )
    _close(y, y_ref, TOL[dtype])


@pytest.mark.parametrize("split", [False, True], ids=["ck", "split"])
def test_sweeps_match_xla_loop(split):
    offsets = (-64, -1, 1, 64)
    diag, off, b, x0 = structured_system(4096, offsets, seed=2)
    y_ref = sweeps_xla(
        jnp.asarray(diag), jnp.asarray(off), offsets, jnp.asarray(b),
        jnp.asarray(x0), 4, 0.7,
    )
    toff = torch.tensor(off)
    if split:
        toff = tuple(toff[:, k] for k in range(toff.shape[1]))
    before = fused_jacobi_sweeps.launches
    y = fused_jacobi_sweeps(
        torch.tensor(diag), toff, offsets, torch.tensor(b), torch.tensor(x0),
        4, 0.7,
    )
    _close(y, y_ref, TOL["f64"])
    assert fused_jacobi_sweeps.launches == before


# --- kernels 2 and 3: momentum_assembly / pc_assembly -------------------


def _asm_inputs(case, dtype):
    """Both packages' kernel inputs for one case: (cols, flags, bc
    values) and seeded fields."""
    jd, td = DTYPES[dtype]
    (mj, tj), (mt, tt) = both(case, dtype)
    vel, p, md = cell_fields(mj.n_cells)
    out = {}
    for tag, mesh, table, ops, dbc, asm, arr in (
        ("jax", mj, tj, jck, jdevice_bc, jasm, lambda a: jnp.asarray(a, jd)),
        ("torch", mt, tt, tck, tdevice_bc, tasm,
         lambda a: torch.tensor(a, dtype=td)),
    ):
        dkw = dict(dtype=jd) if tag == "jax" else dict(dtype=td, device="cpu")
        zc, zs, zv = dbc(table, **dkw)
        ck = ops.build_ck_geometry(mesh, len(table.zone_ids))
        out[tag] = dict(
            cols=asm.column_specs(mesh, table),
            flags=asm.pack_flags(ck.interior, ck.mask),
            bcv=asm.bc_value_table(zs, zv),
            vel=arr(vel), p=arr(p), md=arr(md),
            vol=float(mesh.cell_volume[0]),
        )
    return out["jax"], out["torch"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_assembly_inputs_match(case):
    J, T = _asm_inputs(case, "f64")
    assert tuple(T["cols"]) == tuple(tuple(c) for c in J["cols"])
    np.testing.assert_array_equal(np_(T["flags"]), np_(J["flags"]))
    np.testing.assert_array_equal(np_(T["bcv"]), np_(J["bcv"]))


@pytest.mark.parametrize("scheme", ["ud", "cd1"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_momentum_assembly_matches_pallas_kernel(case, scheme):
    J, T = _asm_inputs(case, "f64")
    ref = jasm.momentum_assembly(
        J["vel"], J["p"], J["bcv"], J["flags"], J["cols"], 1.0, 1e-3, 0.7,
        mom_diag=J["md"], spec=jasm.AsmSpec(scheme=scheme, vol=J["vol"]),
        interpret=True,
    )
    got = tasm.momentum_assembly(
        T["vel"], T["p"], T["bcv"], T["flags"], T["cols"], 1.0, 1e-3, 0.7,
        mom_diag=T["md"], spec=tasm.AsmSpec(scheme=scheme),
    )
    for name, a, b in zip(("diag", "off", "b"), got, ref):
        assert tuple(a.shape) == b.shape, name
        _close(a, b, TOL["f64"], name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pc_assembly_matches_pallas_kernel(case):
    J, T = _asm_inputs(case, "f64")
    ref = jasm.pc_assembly(
        J["vel"], J["md"], J["bcv"], J["flags"], J["cols"], 1.0,
        spec=jasm.AsmSpec(vol=J["vol"]), interpret=True,
    )
    got = tasm.pc_assembly(
        T["vel"], T["md"], T["bcv"], T["flags"], T["cols"], 1.0,
        spec=tasm.AsmSpec(),
    )
    for name, a, b in zip(("diag", "off", "b"), got, ref):
        assert tuple(a.shape) == b.shape, name
        _close(a, b, TOL["f64"], name)


#: The assembly cases of the thread test: the kernel tests' meshes and a
#: 128^2 cavity, whose [C,K,3] face tensors (294,912 values) exceed
#: ATen's 32,768-element grain, so at::parallel_for splits them.
THREAD_CASES = sorted(CASES) + ["cavity128"]


@pytest.mark.parametrize("kernel", ["momentum", "pc"])
@pytest.mark.parametrize("case", THREAD_CASES)
def test_plain_assembly_bits_do_not_depend_on_threads(case, kernel):
    """The plain momentum_assembly (CD1) and pc_assembly give the same
    bits under 1 and 4 intra-op threads (test_pc_assembly_matches_pallas_kernel
    [cavity] once failed with diag off by ~1e-16 in rows 200-399 of 400:
    ROADMAP Queue 3)."""
    from orc_tpu_torch.models.cavity import cavity_case

    if case == "cavity128":
        mesh, table = cavity_case(n=128, device="cpu")
    else:
        mesh, table = both(case)[1]
    zc, zs, zv = tdevice_bc(table, dtype=torch.float64, device="cpu")
    ck = tck.build_ck_geometry(mesh, len(table.zone_ids))
    cols, flags = tasm.column_specs(mesh, table), tasm.pack_flags(ck.interior, ck.mask)
    bcv = tasm.bc_value_table(zs, zv)
    vel, p, md = (torch.tensor(a) for a in cell_fields(mesh.n_cells))

    def run():
        if kernel == "pc":
            return tasm.pc_assembly(vel, md, bcv, flags, cols, 1.0, spec=tasm.AsmSpec())
        return tasm.momentum_assembly(
            vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7, mom_diag=md,
            spec=tasm.AsmSpec(scheme="cd1"),
        )

    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = run()
        torch.set_num_threads(4)
        four = run()
    finally:
        torch.set_num_threads(threads)
    for name, a, b in zip(("diag", "off", "b"), one, four):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("scheme", ["ud", "cd1"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_momentum_assembly_matches_ck_oracle(case, scheme):
    """The plain version against orc_tpu's ck path under the settings
    the kernel gate admits (LinearWeighted faces, implicit relaxation)."""
    J, T = _asm_inputs(case, "f64")
    (mj, tj), _ = both(case)
    zc, zs, zv = jdevice_bc(tj)
    ck = jck.build_ck_geometry(mj, len(tj.zone_ids))
    bc = jck.ck_bc(ck, zc, zs, zv)
    from orc_tpu.utils import settings as js

    settings = js.NumericalSettings(
        momentum=js.MomentumScheme(scheme),
        velocity_interpolation=js.VelocityInterpolation.LINEAR_WEIGHTED,
        pressure_interpolation=js.PressureInterpolation.LINEAR_WEIGHTED,
        relaxation_mode=js.RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
    )
    flux = jck.ck_flux(mj, ck, bc, J["vel"], settings.velocity_interpolation)
    p_f = jck.ck_face_pressure(mj, ck, bc, J["p"], settings.pressure_interpolation)
    diff = jck.ck_diffusion(mj, ck, bc, jnp.asarray(1e-3))
    A, b, _ = jck.ck_momentum(
        mj, ck, bc, settings, 1.0, J["vel"], flux * ck.area, p_f, *diff
    )
    got = tasm.momentum_assembly(
        T["vel"], T["p"], T["bcv"], T["flags"], T["cols"], 1.0, 1e-3, 0.7,
        spec=tasm.AsmSpec(scheme=scheme),
    )
    for name, a, r in zip(("diag", "off", "b"), got, (A.diag, A.off, b)):
        _close(a, r, TOL["f64"], name)


# --- SIMPLE_FC: fc_momentum_assembly / fc_pc_assembly --------------------

#: (momentum scheme, velocity interpolation, pressure interpolation):
#: the windows of orc_tpu's tests/test_pallas_assembly.py.
FC_SCHEMES = {
    "ud-linear": ("UD", "LINEAR_WEIGHTED", "LINEAR_WEIGHTED"),
    "default": ("CD1", "RHIE_CHOW", "SECOND_ORDER"),
    "tvd_dc-rc": ("TVD_DC", "RHIE_CHOW", "LINEAR_WEIGHTED"),
}
#: The parity kernels' branches beyond UD/CD1 + Linear[W]: Rhie-Chow,
#: SecondOrder and TVD_DC (with the UMIST limiter), alone and together.
PARITY_SCHEMES = {
    "default": ("CD1", "RHIE_CHOW", "SECOND_ORDER"),
    "rc": ("CD1", "RHIE_CHOW", "LINEAR_WEIGHTED"),
    "p_so": ("UD", "LINEAR_WEIGHTED", "SECOND_ORDER"),
    "tvd_dc-rc": ("TVD_DC", "RHIE_CHOW", "LINEAR_WEIGHTED"),
    "tvd_dc-so": ("TVD_DC", "LINEAR_WEIGHTED", "SECOND_ORDER"),
}


def _fc_inputs(case, scheme, dtype):
    """Both packages' FC kernel inputs from the same numpy arrays: the
    stored flux is the LinearWeighted flux of another velocity field
    (so a test cannot pass by re-deriving it from vel), the gradients
    are orc_tpu's Green-Gauss gradients of the fields."""
    from orc_tpu.utils import settings as js

    J, T = _asm_inputs(case, dtype)
    jd, td = DTYPES[dtype]
    (mj, tj), _ = both(case, dtype)
    zc, zs, zv = jdevice_bc(tj, dtype=jd)
    ck = jck.build_ck_geometry(mj, len(tj.zone_ids))
    bc = jck.ck_bc(ck, zc, zs, zv)
    rng = np.random.default_rng(12)
    vel2 = jnp.asarray(rng.standard_normal((mj.n_cells, 3)) * 0.1, jd)
    extra = dict(
        flux=jck.ck_flux(mj, ck, bc, vel2, js.VelocityInterpolation.LINEAR_WEIGHTED),
        grad_p=jck.ck_pressure_gradient(mj, ck, bc, J["p"]),
        grad_vel=jck.ck_velocity_gradient(mj, ck, bc, J["vel"]),
    )
    mom, vi, pi = {**FC_SCHEMES, **PARITY_SCHEMES}[scheme]
    settings = js.NumericalSettings(
        momentum=js.MomentumScheme[mom],
        tvd_psi=js.tvd_umist if mom == "TVD_DC" else None,
        velocity_interpolation=js.VelocityInterpolation[vi],
        pressure_interpolation=js.PressureInterpolation[pi],
        relaxation_mode=js.RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
    )
    kw = dict(
        scheme={"UD": "ud", "CD1": "cd1", "TVD_DC": "tvd_dc"}[mom],
        rc=vi == "RHIE_CHOW", p_so=pi == "SECOND_ORDER", vol=J["vol"],
    )
    J.update(extra, spec=jasm.AsmSpec(psi=settings.tvd_psi, **kw), settings=settings,
             mesh=mj, ck=ck, bc=bc)
    from orc_tpu_torch.utils.settings import tvd_umist

    T.update(
        {k: torch.tensor(np.asarray(v), dtype=td) for k, v in extra.items()},
        spec=tasm.AsmSpec(psi=tvd_umist if mom == "TVD_DC" else None, **kw),
    )
    return J, T


def _fc_mom_args(S):
    return (S["vel"], S["p"], S["flux"], S["bcv"], S["flags"], S["cols"],
            1.0, 1e-3, 0.7)


@pytest.mark.parametrize("scheme", sorted(FC_SCHEMES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_fc_momentum_assembly_matches_pallas_kernel(case, scheme):
    """float32, against the interpret-mode SIMPLE_FC branch of
    _momentum_kernel (the dtype and tolerances of orc_tpu's own test)."""
    J, T = _fc_inputs(case, scheme, "f32")
    ref = jasm.fc_momentum_assembly(
        *_fc_mom_args(J), grad_p=J["grad_p"], grad_vel=J["grad_vel"],
        spec=J["spec"], interpret=True,
    )
    got = tasm.fc_momentum_assembly(
        *_fc_mom_args(T), grad_p=T["grad_p"], grad_vel=T["grad_vel"],
        spec=T["spec"],
    )
    for name, a, r, atol in zip(("diag", "off", "b"), got, ref, (1e-7, 1e-7, 1e-6)):
        assert tuple(a.shape) == r.shape, name
        np.testing.assert_allclose(np_(a), np_(r), rtol=2e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("scheme", ["default", "ud-linear"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fc_pc_assembly_matches_pallas_kernel(case, scheme):
    """float32, against the interpret-mode _fc_pc_kernel; flux_h is
    compared under the face mask, as orc_tpu's test does."""
    J, T = _fc_inputs(case, scheme, "f32")
    ref = jasm.fc_pc_assembly(
        J["vel"], J["md"], J["bcv"], J["flags"], J["cols"], 1.0,
        grad_p=J["grad_p"], spec=J["spec"], interpret=True,
    )
    got = tasm.fc_pc_assembly(
        T["vel"], T["md"], T["bcv"], T["flags"], T["cols"], 1.0,
        grad_p=T["grad_p"], spec=T["spec"],
    )
    mask = np.asarray(J["ck"].mask)
    for name, a, r in zip(("diag", "off", "b"), got, ref):
        assert tuple(a.shape) == r.shape, name
        np.testing.assert_allclose(np_(a), np_(r), rtol=2e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        np_(got[3]) * mask, np_(ref[3]) * mask, rtol=2e-5, atol=1e-7
    )


@pytest.mark.parametrize("scheme", sorted(FC_SCHEMES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_fc_momentum_assembly_matches_ck_oracle(case, scheme):
    """float64 at 1e-10: orc_tpu's ck_momentum fed with F = flux A rho,
    the SecondOrder face pressure from the streamed grad p."""
    J, T = _fc_inputs(case, scheme, "f64")
    mj, ck, bc, st = J["mesh"], J["ck"], J["bc"], J["settings"]
    gp_nbr = jck.nbr_values(mj, J["grad_p"], ck.interior)
    p_f = jck.ck_face_pressure(
        mj, ck, bc, J["p"], st.pressure_interpolation,
        grad_p=J["grad_p"], grad_p_nbr=gp_nbr,
    )
    diff = jck.ck_diffusion(mj, ck, bc, jnp.asarray(1e-3))
    A, b, _ = jck.ck_momentum(
        mj, ck, bc, st, 1.0, J["vel"], J["flux"] * ck.area, p_f, *diff,
        grad_vel=J["grad_vel"],
    )
    got = tasm.fc_momentum_assembly(
        *_fc_mom_args(T), grad_p=T["grad_p"], grad_vel=T["grad_vel"],
        spec=T["spec"],
    )
    for name, a, r in zip(("diag", "off", "b"), got, (A.diag, A.off, b)):
        _close(a, r, 1e-10, name)


@pytest.mark.parametrize("scheme", ["default", "ud-linear"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fc_pc_assembly_matches_ck_oracle(case, scheme):
    """float64 at 1e-10: orc_tpu's fc.ck_flux_h + ck_d_coeffs +
    ck_fc_pressure_system."""
    from orc_tpu.solver import fc as jfc

    J, T = _fc_inputs(case, scheme, "f64")
    mj, ck, bc, st = J["mesh"], J["ck"], J["bc"], J["settings"]
    md3 = J["md"][:, None] * jnp.ones((1, 3))
    fh = jfc.ck_flux_h(
        mj, ck, bc, J["vel"], st.velocity_interpolation, p=J["p"],
        grad_p=J["grad_p"], mom_diag=md3,
    )
    d = jfc.ck_d_coeffs(mj, ck, bc, 1.0, md3)
    P, b = jfc.ck_fc_pressure_system(mj, ck, bc, 1.0, fh, d)
    got = tasm.fc_pc_assembly(
        T["vel"], T["md"], T["bcv"], T["flags"], T["cols"], 1.0,
        grad_p=T["grad_p"], spec=T["spec"],
    )
    for name, a, r in zip(("diag", "off", "b", "flux_h"), got, (P.diag, P.off, b, fh)):
        _close(a, r, 1e-10, name)


def test_fc_cpu_tensors_take_the_plain_version():
    _, T = _fc_inputs("couette", "default", "f64")
    before = (tasm.fc_momentum_assembly.launches, tasm.fc_pc_assembly.launches)
    kw = dict(grad_p=T["grad_p"], grad_vel=T["grad_vel"], spec=T["spec"])
    for a, b in zip(
        tasm.fc_momentum_assembly(*_fc_mom_args(T), **kw),
        tasm.fc_momentum_assembly_plain(*_fc_mom_args(T), **kw),
    ):
        assert torch.equal(a, b)
    tasm.fc_pc_assembly(
        T["vel"], T["md"], T["bcv"], T["flags"], T["cols"], 1.0,
        grad_p=T["grad_p"], spec=T["spec"],
    )
    assert (tasm.fc_momentum_assembly.launches, tasm.fc_pc_assembly.launches) == before


@pytest.mark.parametrize("kernel", ["fc_momentum", "fc_pc"])
def test_fc_launches_refuse_a_box_that_does_not_hold_the_rows(kernel):
    """Both SIMPLE_FC launches hold `box` to kernel_box before they reach
    the kernel: too few or too many planes, or a row0 past the first
    plane, raise ValueError."""
    _, T = _fc_inputs("couette", "default", "f64")
    nx, ny, nz, row0 = tasm.kernel_box(T["cols"], T["vel"].shape[0])
    assert (nz, row0) == (1, 0)
    for bad in ((nx, ny, nz - 1, 0), (nx, ny, nz + 1, 0), (nx, ny, nz, nx * ny)):
        with pytest.raises(ValueError, match="box"):
            if kernel == "fc_pc":
                tasm._launch_fc_pc(
                    T["vel"], T["md"], T["bcv"], T["flags"], T["cols"], 1.0,
                    T["grad_p"], T["spec"], bad,
                )
            else:
                tasm._launch_fc_momentum(
                    *_fc_mom_args(T), T["grad_p"], T["grad_vel"], None, T["spec"], bad
                )


def test_fc_transient_assembly_raises():
    """The transient branch takes (rv_dt [C], vel_n [C,3]) and raises on
    any other inertia; tests/test_torch_transient.py holds its values."""
    _, T = _fc_inputs("cavity", "ud-linear", "f64")
    steady = tasm.fc_momentum_assembly(*_fc_mom_args(T), spec=T["spec"])
    diag, _off, _b = tasm.fc_momentum_assembly(
        *_fc_mom_args(T), inertia=(T["md"], T["vel"]), spec=T["spec"]
    )
    assert torch.allclose(diag, steady[0] + T["md"] / 0.7)
    with pytest.raises(ValueError):
        tasm.fc_momentum_assembly(
            *_fc_mom_args(T), inertia=(T["md"], T["vel"][:, :2]), spec=T["spec"]
        )


# --- the parity kernels' Rhie-Chow / SecondOrder / TVD_DC / GG branches ----


def _parity_inputs(case, scheme, dtype, gg):
    """_fc_inputs for a parity branch: both specs with `gg` (in-kernel
    Green-Gauss gradient) set; the streamed grad_p is orc_tpu's
    Green-Gauss gradient of p, which gg must reproduce."""
    J, T = _fc_inputs(case, scheme, dtype)
    J["spec"] = J["spec"]._replace(gg=gg)
    T["spec"] = T["spec"]._replace(gg=gg)
    return J, T


def _parity_mom_kw(S):
    return dict(grad_p=None if S["spec"].gg else S["grad_p"], mom_diag=S["md"],
                grad_vel=S["grad_vel"], spec=S["spec"])


def _parity_pc_kw(S):
    return dict(p=S["p"], grad_p=None if S["spec"].gg else S["grad_p"], spec=S["spec"])


#: (case, branch, gg) of the interpret-mode comparisons: each costs an
#: interpret-mode compile, so a few cover the branches and BC kinds
#: (the couette's pressure columns reach the GG pressure-BC faces).
PARITY_PALLAS = [
    ("cavity", "default", True),
    ("couette", "default", False),
    ("vinlet", "tvd_dc-rc", True),
    ("couette", "p_so", True),
]


@pytest.mark.parametrize("case,scheme,gg", PARITY_PALLAS)
def test_parity_momentum_branches_match_pallas_kernel(case, scheme, gg):
    """float32, against the interpret-mode parity _momentum_kernel with
    the same spec (the window of tests/test_pallas_assembly.py: rtol
    2e-5)."""
    J, T = _parity_inputs(case, scheme, "f32", gg)
    args = lambda S: (S["vel"], S["p"], S["bcv"], S["flags"], S["cols"], 1.0, 1e-3, 0.7)  # noqa: E731
    ref = jasm.momentum_assembly(*args(J), **_parity_mom_kw(J), interpret=True)
    got = tasm.momentum_assembly(*args(T), **_parity_mom_kw(T))
    for name, a, r, atol in zip(("diag", "off", "b"), got, ref, (1e-7, 1e-7, 1e-6)):
        assert tuple(a.shape) == r.shape, name
        np.testing.assert_allclose(np_(a), np_(r), rtol=2e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("case,gg", [("couette", True), ("cavity", False)])
def test_parity_pc_rhie_chow_matches_pallas_kernel(case, gg):
    J, T = _parity_inputs(case, "default", "f32", gg)
    args = lambda S: (S["vel"], S["md"], S["bcv"], S["flags"], S["cols"], 1.0)  # noqa: E731
    ref = jasm.pc_assembly(*args(J), **_parity_pc_kw(J), interpret=True)
    got = tasm.pc_assembly(*args(T), **_parity_pc_kw(T))
    for name, a, r in zip(("diag", "off", "b"), got, ref):
        assert tuple(a.shape) == r.shape, name
        np.testing.assert_allclose(np_(a), np_(r), rtol=2e-5, atol=1e-6, err_msg=name)


def _ck_oracle_flux(J, face_model):
    """orc_tpu's ck face flux and Green-Gauss gradient (the gradient both
    gg settings must use), float64."""
    mj, ck, bc, st = J["mesh"], J["ck"], J["bc"], J["settings"]
    gp = jck.ck_pressure_gradient(mj, ck, bc, J["p"])
    gp_nbr = jck.nbr_values(mj, gp, ck.interior)
    md3 = J["md"][:, None] * jnp.ones((1, 3))
    flux = jck.ck_flux(
        mj, ck, bc, J["vel"], face_model, p=J["p"], grad_p=gp,
        grad_p_nbr=gp_nbr, mom_diag=md3,
    )
    return flux, gp, gp_nbr, md3


@pytest.mark.parametrize("gg", [True, False], ids=["gg", "streamed"])
@pytest.mark.parametrize("scheme", sorted(PARITY_SCHEMES))
@pytest.mark.parametrize("case", ["cavity3d", "couette"])
def test_parity_momentum_branches_match_ck_oracle(case, scheme, gg):
    """float64 at 1e-10: orc_tpu's ck path under the branch's settings
    (ck_flux, ck_face_pressure, ck_momentum), its Green-Gauss grad p
    streamed or recomputed in the kernel."""
    J, T = _parity_inputs(case, scheme, "f64", gg)
    mj, ck, bc, st = J["mesh"], J["ck"], J["bc"], J["settings"]
    flux, gp, gp_nbr, _md3 = _ck_oracle_flux(J, st.velocity_interpolation)
    p_f = jck.ck_face_pressure(
        mj, ck, bc, J["p"], st.pressure_interpolation, grad_p=gp, grad_p_nbr=gp_nbr
    )
    diff = jck.ck_diffusion(mj, ck, bc, jnp.asarray(1e-3))
    A, b, _ = jck.ck_momentum(
        mj, ck, bc, st, 1.0, J["vel"], flux * ck.area, p_f, *diff,
        grad_vel=J["grad_vel"],
    )
    got = tasm.momentum_assembly(
        T["vel"], T["p"], T["bcv"], T["flags"], T["cols"], 1.0, 1e-3, 0.7,
        **_parity_mom_kw(T),
    )
    for name, a, r in zip(("diag", "off", "b"), got, (A.diag, A.off, b)):
        _close(a, r, 1e-10, name)


@pytest.mark.parametrize("gg", [True, False], ids=["gg", "streamed"])
@pytest.mark.parametrize("case", ["cavity3d", "couette"])
def test_parity_pc_rhie_chow_matches_ck_oracle(case, gg):
    """float64 at 1e-10: orc_tpu's Rhie-Chow ck_flux (iteration-start p
    and grad p, the post-momentum diagonal) + ck_pressure_correction."""
    J, T = _parity_inputs(case, "rc", "f64", gg)
    mj, ck, bc = J["mesh"], J["ck"], J["bc"]
    flux, _gp, _gpn, md3 = _ck_oracle_flux(J, J["settings"].velocity_interpolation)
    P, b = jck.ck_pressure_correction(mj, ck, bc, 1.0, flux * ck.area, md3)
    got = tasm.pc_assembly(
        T["vel"], T["md"], T["bcv"], T["flags"], T["cols"], 1.0, **_parity_pc_kw(T)
    )
    for name, a, r in zip(("diag", "off", "b"), got, (P.diag, P.off, b)):
        _close(a, r, 1e-10, name)


def test_parity_assembly_refuses_only_the_transient_branch():
    """Every spec has a kernel, steady and transient; only an inertia that
    is not (rv_dt [C], vel_n [C,3]) is refused."""
    _, T = _parity_inputs("cavity", "tvd_dc-rc", "f64", True)
    args = (T["vel"], T["p"], T["bcv"], T["flags"], T["cols"], 1.0, 1e-3, 0.7)
    steady = tasm.momentum_assembly(*args, **_parity_mom_kw(T))
    diag, _off, _b = tasm.momentum_assembly(
        *args, inertia=(T["md"], T["vel"]), **_parity_mom_kw(T)
    )
    assert torch.allclose(diag, steady[0] + T["md"] / 0.7)
    with pytest.raises(ValueError, match="inertia"):
        tasm.momentum_assembly(
            *args, inertia=(T["md"][:-1], T["vel"]), **_parity_mom_kw(T)
        )


@pytest.mark.parametrize("scheme", ["UD", "CD1", "TVD_DC", "CD2", "TVD"])
def test_kernel_gate_admits_what_orc_tpu_admits(monkeypatch, scheme):
    """_kernel_asm_spec(fc=False) against orc_tpu's _pallas_asm_spec over
    every face-velocity and face-pressure model and both gradient
    methods of the (c,k) step: the same configurations get a spec, with
    the same scheme, face models, volume and gg (the port's gate with
    the mesh read as on the card, orc_tpu's forced on its CPU); under
    least squares gg is False (the kernels take the streamed gradient)."""
    from orc_tpu.solver import simple as jsimple
    from orc_tpu.utils import settings as js

    from orc_tpu_torch.ops.ck_ops import build_ck_geometry
    from orc_tpu_torch.solver import simple as tsimple
    from orc_tpu_torch.utils import settings as tset

    monkeypatch.setenv("ORC_TPU_PALLAS_ASM", "force")
    monkeypatch.setattr(tsimple, "_on_cuda", lambda mesh: True)
    (mj, tj), (mt, tt) = both("couette", "f32")
    ckj = jck.build_ck_geometry(mj, len(tj.zone_ids))
    ckt = build_ck_geometry(mt, len(tt.zone_ids))
    admitted = 0
    gradients = (
        tset.GradientReconstruction.GREEN_GAUSS_CELL,
        tset.GradientReconstruction.LEAST_SQUARES,
    )
    for gr in gradients:
        for vi in tset.VelocityInterpolation:
            for pi in tset.PressureInterpolation:
                s = tset.NumericalSettings(
                    momentum=tset.MomentumScheme[scheme],
                    tvd_psi=tset.tvd_umist if scheme in ("TVD", "TVD_DC") else None,
                    velocity_interpolation=vi, pressure_interpolation=pi,
                    relaxation_mode=tset.RelaxationMode.IMPLICIT,
                    gradient_reconstruction=gr,
                )
                ref = jsimple._pallas_asm_spec(mj, tj, to_jax_settings(s), ckj, fc=False)
                got = tsimple._kernel_asm_spec(mt, tt, s, ckt, fc=False)
                assert (got is None) == (ref is None), (gr, vi, pi)
                if got is None:
                    continue
                admitted += 1
                (cols, spec), (jcols, jspec, _interp) = got, ref
                assert tuple(cols) == tuple(tuple(c) for c in jcols)
                for f in ("scheme", "rc", "p_so", "vol", "gg"):
                    assert getattr(spec, f) == getattr(jspec, f), (f, gr, vi, pi)
                assert (spec.psi is None) == (jspec.psi is None)
                if gr == tset.GradientReconstruction.LEAST_SQUARES:
                    assert not spec.gg
    explicit = tset.NumericalSettings(momentum=tset.MomentumScheme[scheme])
    assert tsimple._kernel_asm_spec(mt, tt, explicit, ckt) is None
    assert admitted == (18 if scheme in ("UD", "CD1", "TVD_DC") else 0)


def test_failed_build_raises(monkeypatch):
    """No nvcc: the loader raises instead of falling back."""
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build()
