"""The port's extended `bench` lines (orc_tpu_torch/bench.py) against
orc_tpu's (the repository's bench.py, loaded by path), on the CPU at
BENCH_EXT_N=16:

- the metric names of `extended_metrics`, in order (both leave out the
  fused-kernel lines 3-5 on the CPU, where neither gate gives a spec);
- the byte count of each bandwidth line against orc_tpu's formula;
- the fused momentum + p' pair of lines 3-5 called directly with a spec
  from `column_specs`, against orc_tpu's interpret-mode pair on the same
  seeded f32 inputs, at tests/test_torch_kernels.py's f32 tolerance;
- `main`: the extra lines before the headline, none under
  BENCH_EXTENDED=0, and an extra that raises leaves the headline printed
  and the error on stderr.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from torch_parity import np_

import jax.numpy as jnp
from orc_tpu.models.cavity import cavity_case as j_cavity
from orc_tpu.ops import pallas_assembly as jasm
from orc_tpu.ops.ck_ops import build_ck_geometry as j_ck_geometry
from orc_tpu.ops.fields import device_bc as j_device_bc

from orc_tpu_torch import bench
from orc_tpu_torch.models.cavity import cavity_case as t_cavity
from orc_tpu_torch.ops import fused_assembly as tasm
from orc_tpu_torch.ops.ck_ops import build_ck_geometry as t_ck_geometry
from orc_tpu_torch.ops.fields import device_bc as t_device_bc

REPO = pathlib.Path(__file__).resolve().parents[1]
N_EXT = 16
TOL_F32 = 2e-6  # tests/test_torch_kernels.py's TOL["f32"]


def _repo_bench():
    spec = importlib.util.spec_from_file_location("repo_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_lines():
    mp = pytest.MonkeyPatch()
    mp.setenv("BENCH_EXT_N", str(N_EXT))
    try:
        yield bench.extended_metrics("cpu")
    finally:
        mp.undo()


def test_extended_metric_names_equal_orc_tpus(port_lines, monkeypatch):
    """orc_tpu's lines with its timers stubbed (the names and the gates
    are the subject here, not its CPU times)."""
    import time

    import orc_tpu.solver.simple as js

    repo_bench = _repo_bench()
    monkeypatch.setenv("BENCH_EXT_N", str(N_EXT))
    monkeypatch.setattr(repo_bench, "_scan_slope", lambda f, x0, n=512: 1.0)

    def runner(*args, **kwargs):
        def run(state, *a):
            time.sleep(1e-3)
            return state, None

        return run

    monkeypatch.setattr(js, "_make_chunk_runner", runner)
    names = [line["metric"] for line in repo_bench.extended_metrics()]
    assert [line["metric"] for line in port_lines] == names
    assert len(names) == 4  # lines 1, 2, 6 and 7 on the CPU


def test_extended_lines_are_well_formed(port_lines):
    units = [line["unit"] for line in port_lines]
    assert units == ["GB/s", "GB/s", "ms/iter", "ms/iter"]
    for line in port_lines:
        assert np.isfinite(line["value"]) and line["value"] >= 0
    assert "vs_baseline" not in port_lines[2]
    assert port_lines[3]["vs_baseline"] > 0


@pytest.mark.parametrize("nz", [1, 4])
def test_byte_counts_equal_orc_tpus_formulas(nz):
    """orc_tpu's inline formulas (bench.py), for the box's C and K and
    for the cavity's columns."""
    from orc_tpu_torch.mesh import structured_box_mesh

    mesh, _ = structured_box_mesh(N_EXT, N_EXT, nz, dtype=torch.float32, device="cpu")
    C, K = mesh.cell_neighbors.shape
    assert bench.spmv_bytes(C, K) == C * 4 * (K + 3)
    assert bench.assembly_bytes(C, K) == C * 4 * (3 + 1 + 3 + K + 1 + 3 + K + 1 + 1 + 1)
    mesh_f, table_f = t_cavity(n=N_EXT, nz=nz, dtype=torch.float32, device="cpu")
    Cf, Kf = mesh_f.n_cells, len(tasm.column_specs(mesh_f, table_f))
    assert bench.fused_bytes(Cf, Kf) == Cf * 4 * ((4 + 1 + 1 + Kf + 3) + (4 + 1 + 1 + Kf + 1))
    assert bench.fused_rc_bytes(Cf, Kf) == Cf * 4 * (
        (1 + 2) + (4 + 2 + 1 + 1 + 1 + Kf + 3) + (7 + 1 + 1 + Kf + 1)
    )
    assert bench.fused_gg_bytes(Cf, Kf) == Cf * 4 * ((6 + 4 + Kf) + (6 + 2 + Kf))


def test_spmv_case_draws_orc_tpus_inputs():
    """Line 1's system: orc_tpu's draws from default_rng(0)."""
    from orc_tpu.mesh import structured_box_mesh as j_box

    mesh, _, diag, off, x = bench.spmv_case(N_EXT, "cpu", np.random.default_rng(0))
    mj, _ = j_box(N_EXT, N_EXT, 1, dtype=jnp.float32)
    C, K = mj.cell_neighbors.shape
    interior = np.asarray(mj.face_interior[mj.cell_faces] & mj.cell_face_mask)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(np_(diag), rng.standard_normal(C).astype(np.float32))
    np.testing.assert_array_equal(
        np_(off), (rng.standard_normal((C, K)) * interior).astype(np.float32)
    )
    np.testing.assert_array_equal(np_(x), rng.standard_normal(C).astype(np.float32))
    assert mesh.neighbor_offsets == mj.neighbor_offsets


#: Lines 3 and 4's specs: (scheme, rc, p_so, gg).
PAIR_SPECS = {
    "ud": ("ud", False, False, False),
    "cd1+so+rc gg": ("cd1", True, True, True),
}


@pytest.mark.parametrize("name", sorted(PAIR_SPECS))
def test_fused_pair_matches_orc_tpus_interpret_pair(name):
    """bench.fused_pair on the CPU (the plain versions of kernels 3 and
    5) against orc_tpu's pair of bench.py (`fused_pair` / `fused_rc`) in
    interpret mode, one step of seeded f32 inputs on the 16^2 cavity."""
    scheme, rc, p_so, gg = PAIR_SPECS[name]
    mj, tj = j_cavity(n=N_EXT, dtype=jnp.float32)
    mt, tt = t_cavity(n=N_EXT, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    C = mt.n_cells
    vel = rng.standard_normal((C, 3)) * 1e-3
    p = rng.standard_normal(C) * 1e-3
    md = 1.0 + rng.random(C)

    ckj = j_ck_geometry(mj, len(tj.zone_ids))
    _, zsj, zvj = j_device_bc(tj, dtype=jnp.float32)
    colsj = jasm.column_specs(mj, tj)
    specj = jasm.AsmSpec(scheme=scheme, rc=rc, p_so=p_so, gg=gg, vol=float(mj.cell_volume[0]))
    flagsj, bcvj = jasm.pack_flags(ckj.interior, ckj.mask), jasm.bc_value_table(zsj, zvj)
    a = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    kw = dict(spec=specj, interpret=True)
    if rc:
        momj = jasm.momentum_assembly(
            a(vel), a(p), bcvj, flagsj, colsj, 1.0, 1e-3, 0.7, grad_p=None,
            mom_diag=a(md), **kw,
        )
        pcj = jasm.pc_assembly(
            a(vel), momj[0], bcvj, flagsj, colsj, 1.0, p=a(p), grad_p=None, **kw
        )
    else:
        momj = jasm.momentum_assembly(a(vel), a(p), bcvj, flagsj, colsj, 1.0, 1e-3, 0.7, **kw)
        pcj = jasm.pc_assembly(a(vel), momj[0], bcvj, flagsj, colsj, 1.0, **kw)

    ckt = t_ck_geometry(mt, len(tt.zone_ids))
    _, zst, zvt = t_device_bc(tt, dtype=torch.float32, device="cpu")
    colst = tasm.column_specs(mt, tt)
    assert tuple(colst) == tuple(tuple(c) for c in colsj)
    spect = tasm.AsmSpec(scheme=scheme, rc=rc, p_so=p_so, gg=gg, vol=float(mt.cell_volume[0]))
    t = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    momt, pct = bench.fused_pair(
        t(vel), t(p), t(md), tasm.bc_value_table(zst, zvt),
        tasm.pack_flags(ckt.interior, ckt.mask), colst, spect,
    )
    for kernel, got, ref in (("momentum", momt, momj), ("pc", pct, pcj)):
        for out, g, r in zip(("diag", "off", "b"), got, ref):
            d = np_(r)
            assert tuple(g.shape) == d.shape, (kernel, out)
            np.testing.assert_allclose(
                np_(g), d, rtol=TOL_F32, atol=TOL_F32 * float(np.max(np.abs(d))),
                err_msg=f"{kernel} {out}",
            )


def _main_lines(capsys, monkeypatch, extended, extras=None):
    monkeypatch.setenv("BENCH_ITERS", "2")
    if extended is None:
        monkeypatch.delenv("BENCH_EXTENDED", raising=False)
    else:
        monkeypatch.setenv("BENCH_EXTENDED", extended)
    if extras is not None:
        monkeypatch.setattr(bench, "extended_metrics", extras)
    headline = bench.main("cpu")
    out, err = capsys.readouterr()
    lines = [json.loads(s) for s in out.strip().splitlines()]
    assert lines[-1] == headline
    assert headline["metric"].startswith("SIMPLE iters/sec, couette_128x64x1")
    return lines, err


def test_main_prints_the_extras_then_the_headline(port_lines, capsys, monkeypatch):
    """main prints what extended_metrics returns (here the module's run
    of it), in order, before the headline."""
    calls = []

    def extras(device):
        calls.append(str(device))
        return port_lines

    lines, _ = _main_lines(capsys, monkeypatch, None, extras)
    assert calls == ["cpu"]
    assert lines[:-1] == port_lines


def test_main_without_extended_prints_the_headline_only(capsys, monkeypatch):
    def extras(device):
        raise AssertionError("BENCH_EXTENDED=0 ran the extras")

    lines, _ = _main_lines(capsys, monkeypatch, "0", extras)
    assert len(lines) == 1


def test_failing_extras_leave_the_headline(capsys, monkeypatch):
    def extras(device):
        raise RuntimeError("boom")

    lines, err = _main_lines(capsys, monkeypatch, "1", extras)
    assert len(lines) == 1
    assert "extended metrics failed: RuntimeError('boom')" in err


def test_cavity_lines_run_the_parity_step_as_orc_tpus(monkeypatch):
    """Lines 6-7 time the (c,k) parity step, as orc_tpu's bench does
    (its `_make_chunk_runner` without use_fc), also under the reference
    schemes of line 7, which the solver's AUTO coupling would resolve to
    SIMPLE_FC."""
    import dataclasses as dc

    from orc_tpu_torch.solver import fc, simple
    from orc_tpu_torch.utils.settings import (
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        PressureVelocityCoupling,
        RelaxationMode,
        VelocityInterpolation,
    )

    s_ref = dc.replace(
        NumericalSettings(),
        momentum=MomentumScheme.CD1,
        pressure_interpolation=PressureInterpolation.SECOND_ORDER,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        momentum_relaxation=0.7,
        pressure_relaxation=0.1,
        relaxation_mode=RelaxationMode.IMPLICIT,
    )
    assert s_ref.resolved_coupling() == PressureVelocityCoupling.SIMPLE_FC
    calls = []
    parity = simple.ck_simple_step

    def counted(*args, **kwargs):
        calls.append("parity")
        return parity(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("the bench ran the SIMPLE_FC step")

    monkeypatch.setattr(simple, "ck_simple_step", counted)
    monkeypatch.setattr(fc, "ck_simple_step_fc", refused)
    mesh, table = t_cavity(n=8, dtype=torch.float32, device="cpu")
    ms = bench._cavity_chunk_ms(mesh, table, s_ref, n_it=2)
    assert ms > 0 and len(calls) == 12
