"""The port's case files (orc_tpu_torch/utils/config.py) against
orc_tpu's on the CPU.

- parse_case gives orc_tpu's Case field by field (the settings member by
  member, through torch_parity.to_jax_settings) for every
  examples/*.toml and for default_case_toml();
- build_problem compiles the same mesh (cell centroids, volumes,
  neighbours, zone slots and offsets exactly) and the same BC tables,
  on shrunk copies of the examples (chip_smoke.case_copy);
- a live zone retyped "periodic" raises orc_tpu's ValueError, and so do
  the generate / green_gauss_node and mesh-file / sequencing clashes;
- the body-force source is orc_tpu's (float64, 1e-15 of scale: the
  same products);
- sequencing_schedule is orc_tpu's, the stop at an odd dimension
  included.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import chip_smoke, np_, to_jax_settings

from orc_tpu.utils import config as jcfg

from orc_tpu_torch.mesh.generate import write_tgrid
from orc_tpu_torch.ops.fields import momentum_source_term
from orc_tpu_torch.utils import config as tcfg

EXAMPLES = sorted((Path(__file__).resolve().parent.parent / "examples").glob("*.toml"))
TEXTS = {p.stem: p.read_text() for p in EXAMPLES}
TEXTS["default"] = tcfg.default_case_toml()


def test_default_case_toml_is_orc_tpus():
    assert tcfg.default_case_toml() == jcfg.default_case_toml()


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_case_field_by_field(name):
    cj, ct = jcfg.parse_case(TEXTS[name]), tcfg.parse_case(TEXTS[name])
    for f in dataclasses.fields(ct):
        a, b = getattr(ct, f.name), getattr(cj, f.name)
        if f.name == "settings":
            assert to_jax_settings(a) == b
        else:
            assert a == b, f.name


def _shrunk(name, tmp_path):
    cap = 8 if name == "cavity_3d" else 16
    return chip_smoke().case_copy(
        TEXTS[name], tmp_path, iterations=3, steps=2, inner=3, cap=cap, levels=2,
    )


@pytest.mark.parametrize("name", [p.stem for p in EXAMPLES])
def test_build_problem_mesh_and_tables(name, tmp_path):
    text = _shrunk(name, tmp_path)
    mj, tj = jcfg.build_problem(jcfg.parse_case(text))
    mt, tt = tcfg.build_problem(tcfg.parse_case(text), device="cpu")
    for field in ("cell_centroid", "cell_volume", "cell_neighbors", "face_zone_slot", "face_area"):
        np.testing.assert_array_equal(np_(getattr(mt, field)), np_(getattr(mj, field)), field)
    assert mt.neighbor_offsets == mj.neighbor_offsets and mt.dtype == torch.float64
    assert tt.zone_ids == tj.zone_ids
    np.testing.assert_array_equal(tt.codes, tj.codes)
    np.testing.assert_array_equal(tt.scalar, tj.scalar)
    np.testing.assert_array_equal(tt.vector, tj.vector)
    assert [tt.zones[z].name for z in tt.zone_ids] == [tj.zones[z].name for z in tj.zone_ids]


def test_build_problem_device_default_is_cuda():
    """Like every entry point of the port, build_problem compiles onto the
    CUDA device unless told otherwise (and raises without a GPU)."""
    case = tcfg.parse_case(TEXTS["cavity"])
    if torch.cuda.is_available():
        assert tcfg.build_problem(case)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tcfg.build_problem(case)


def test_live_periodic_zone_rejected(tmp_path):
    text = _shrunk("couette_flow", tmp_path).replace(
        '[boundaries.INLET]\ntype = "pressure_inlet"', '[boundaries.INLET]\ntype = "periodic"'
    )
    with pytest.raises(ValueError) as ej:
        jcfg.build_problem(jcfg.parse_case(text))
    with pytest.raises(ValueError) as et:
        tcfg.build_problem(tcfg.parse_case(text), device="cpu")
    assert str(et.value) == str(ej.value) and "still has faces" in str(et.value)


@pytest.mark.parametrize("clash", ["gg_node_generate", "mesh_sequencing", "no_mesh", "bad_scheme"])
def test_case_errors_match(clash, tmp_path):
    text = _shrunk("cavity", tmp_path)
    if clash == "gg_node_generate":
        text = text.replace('momentum = "ud"', 'momentum = "ud"\ngradient_reconstruction = "green_gauss_node"')
    elif clash == "mesh_sequencing":
        path = tmp_path / "box.msh"
        write_tgrid(str(path), 4, 4, 1)
        text = chip_smoke().case_copy(TEXTS["cavity_sequenced"], tmp_path, mesh=path)
    elif clash == "no_mesh":
        text = text.replace("[case.generate]", "[unused]")
    else:
        text = text.replace('momentum = "ud"', 'momentum = "upwind9"')

    def outcome(cfg, **kw):
        try:
            case = cfg.parse_case(text)
            if clash == "mesh_sequencing":
                cfg.build_problem(case, dims=(2, 2, 1), **kw)
            else:
                cfg.build_problem(case, **kw)
        except ValueError as e:
            return str(e)
        return None

    msg = outcome(tcfg, device="cpu")
    assert msg is not None and msg == outcome(jcfg)


def test_body_force_source(tmp_path):
    text = _shrunk("periodic_channel", tmp_path)
    cj, ct = jcfg.parse_case(text), tcfg.parse_case(text)
    mj, _ = jcfg.build_problem(cj)
    mt, _ = tcfg.build_problem(ct, device="cpu")
    got = momentum_source_term(ct.settings.momentum_source, mt.cell_centroid, mt.cell_volume)
    want = np_(cj.settings.momentum_source(mj.cell_centroid, mj.cell_volume))
    assert got.dtype == torch.float64 and tuple(got.shape) == (mt.n_cells, 3)
    np.testing.assert_allclose(np_(got), want, rtol=0, atol=1e-15 * np.abs(want).max())
    assert np.abs(want[:, 0]).min() > 0 and not want[:, 1:].any()


@pytest.mark.parametrize("dims,seq", [
    ((256, 256, 1), {"levels": 3}),
    ((12, 12, 1), {"levels": 4}),  # 12 -> 6 -> 3, stops at the odd 3
    ((16, 9, 1), {"levels": 3}),  # odd from the start: one level
    ((8, 8, 8), {"levels": 5}),  # stops where halving changes nothing
    ((64, 64, 1), {"dims": [[16, 16, 1], [64, 64, 1]]}),
])
def test_sequencing_schedule(dims, seq):
    nx, ny, nz = dims
    rows = "\n".join(f"{k} = {v!r}".replace("'", '"') for k, v in seq.items())
    text = (f"[case]\n[case.generate]\nnx = {nx}\nny = {ny}\nnz = {nz}\n"
            f"[case.sequencing]\n{rows}\n")
    got = tcfg.sequencing_schedule(tcfg.parse_case(text))
    assert got == jcfg.sequencing_schedule(jcfg.parse_case(text))
    assert got[-1] == dims
    assert tcfg.sequencing_schedule(tcfg.parse_case(TEXTS["cavity"])) is None
