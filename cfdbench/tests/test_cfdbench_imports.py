"""In a fresh process, the harness, the reference and the port's modules
that a run loads import no module whose top-level name is exactly jax,
jaxlib, flax or orc_tpu."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CODE = """
import sys
import cfdbench.run, cfdbench.control, cfdbench.layout, cfdbench.trace
import cfdbench.reference.box, cfdbench.reference.judge
import cfdbench.reference.simple, cfdbench.reference.simple_fc
import cfdbench.layout_mesh, cfdbench.meshes.tgrid, cfdbench.meshes.graded_box
import cfdbench.reference.mesh, cfdbench.reference.mesh_simple, cfdbench.reference.mesh_fc
import cfdbench.metrics.hbm_bytes
import json, pathlib
bench = json.loads(pathlib.Path("BENCHMARK.json").read_text())
import importlib
for m in bench["per_layer"]:
    importlib.import_module("cfdbench.metrics." + m["name"])
import orc_tpu_torch.models.cavity, orc_tpu_torch.solver.simple, orc_tpu_torch.solver.fc
import orc_tpu_torch.solver.gmg, orc_tpu_torch.utils.config, orc_tpu_torch.ops._cuda
import orc_tpu_torch.ops.fused_assembly, orc_tpu_torch.ops.fused_smooth
import orc_tpu_torch.mesh.tgrid, orc_tpu_torch.mesh.native, orc_tpu_torch.mesh.reorder
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_no_jax_and_no_orc_tpu():
    out = subprocess.run(
        [sys.executable, "-c", CODE], cwd=ROOT, capture_output=True, text=True, check=True
    ).stdout
    top = set(eval(out.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "orc_tpu"}, top
    assert "orc_tpu_torch" in top and "cfdbench" in top


REFERENCE_CODE = """
import sys, pkgutil, importlib
import cfdbench.meshes, cfdbench.reference
for pkg in (cfdbench.meshes, cfdbench.reference):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(pkg.__name__ + "." + m.name)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_meshes_and_reference_import_nothing_of_the_program():
    """The generators and the plain reference import neither the program
    nor JAX, nor the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE_CODE], cwd=ROOT, capture_output=True, text=True, check=True
    ).stdout
    top = set(eval(out.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "orc_tpu", "orc_tpu_torch"}, top
    assert "cfdbench" in top


def test_the_check_in_run_compares_whole_names(monkeypatch):
    from cfdbench import run

    monkeypatch.setitem(sys.modules, "orc_tpu_torch_like", sys)
    assert "orc_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]
