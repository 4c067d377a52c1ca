"""Helpers for the port's parity tests: one input through orc_tpu (JAX on
CPU, x64 on via `import orc_tpu`) and orc_tpu_torch (torch on CPU).

Inputs are made with numpy from a seed and handed to both packages;
results come back as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

import jax.numpy as jnp
import orc_tpu  # noqa: F401  (enables JAX x64)
from orc_tpu.mesh.zones import FaceCondition as JFaceCondition
from orc_tpu.utils import settings as jset

from orc_tpu_torch.mesh.zones import FaceCondition

# The tier-1 run shares 8 cores among 6 xdist workers.
torch.set_num_threads(2)

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


def np_(x):
    """numpy copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_jax_settings(obj):
    """The orc_tpu counterpart of a port settings object, member by
    member (enums by class name and value, limiters by name)."""
    if isinstance(obj, enum.Enum):
        return getattr(jset, type(obj).__name__)(obj.value)
    if dataclasses.is_dataclass(obj):
        cls = getattr(jset, type(obj).__name__)
        return cls(
            **{
                f.name: to_jax_settings(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
            }
        )
    if callable(obj):
        return getattr(jset, obj.__name__)
    return obj


# --- cases (the boxes of tests/test_pallas_assembly.py) ---------------


def _cavity(pkg, n, dtype, nz=1):
    if pkg == "jax":
        from orc_tpu.models.cavity import cavity_case

        return cavity_case(n=n, nz=nz, dtype=dtype)
    from orc_tpu_torch.models.cavity import cavity_case

    return cavity_case(n=n, nz=nz, dtype=dtype, device="cpu")


def _channel(pkg, dtype, vinlet: bool):
    if pkg == "jax":
        from orc_tpu.mesh.generate import structured_box_mesh

        fc = JFaceCondition
    else:
        from orc_tpu_torch.mesh.generate import structured_box_mesh

        fc = FaceCondition
    kw = {} if pkg == "jax" else dict(device="cpu")
    mesh, table = structured_box_mesh(
        16, 8, 1, lengths=(0.002, 0.001, 0.0001), dtype=dtype, **kw
    )
    if vinlet:
        table.set("INLET", fc.VELOCITY_INLET, vector_value=(1e-3, 0, 0))
    else:
        table.set("TOP_WALL", fc.WALL, vector_value=(5e-4, 0, 0))
        table.set("INLET", fc.PRESSURE_INLET, scalar_value=0.01)
    table.set("OUTLET", fc.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", fc.SYMMETRY)
    table.set("PERIODIC_+Z", fc.SYMMETRY)
    return mesh, table


def _jax_box(n, nz=1):
    from orc_tpu.models.cavity import cavity_case

    return cavity_case(n=n, nz=nz, dtype=jnp.float64)


def permuted_arrays(n, seed=0, nz=1):
    """compile_from_arrays keyword arguments of the n x n (x nz) cavity
    with randomly permuted cell ids (no structured offsets survive), and
    the permutation; numpy, from orc_tpu's box. Cell i of the permuted
    mesh is cell perm[i] of the box. seed=None keeps the box's order."""
    mesh, _ = _jax_box(n, nz)
    C = mesh.n_cells
    perm = (
        np.arange(C) if seed is None
        else np.random.default_rng(seed).permutation(C)
    )
    inv = np.empty(C, np.int64)
    inv[perm] = np.arange(C)
    interior = np.asarray(mesh.face_interior)
    kw = dict(
        dim=2 if nz == 1 else 3,
        face_owner=inv[np.asarray(mesh.face_owner)],
        face_neighbor=np.where(interior, inv[np.asarray(mesh.face_neighbor)], -1),
        face_area=np.asarray(mesh.face_area),
        face_normal=np.asarray(mesh.face_normal),
        face_centroid=np.asarray(mesh.face_centroid),
        face_zone_slot=np.asarray(mesh.face_zone_slot),
        cell_centroid=np.asarray(mesh.cell_centroid)[perm],
        cell_volume=np.asarray(mesh.cell_volume)[perm],
    )
    return kw, perm


def graded_arrays(n, ratio=1.15):
    """compile_from_arrays keyword arguments of an n x n x 1 unit box
    whose x and y spacings grow geometrically by `ratio` per cell (the
    uniform box's topology and normals, graded geometry); numpy."""
    mesh, _ = _jax_box(n)
    w = ratio ** np.arange(n)
    edges = np.concatenate([[0.0], np.cumsum(w / w.sum())])
    mid = 0.5 * (edges[:-1] + edges[1:])
    width = np.diff(edges)
    fc = np.asarray(mesh.face_centroid)
    axis = np.argmax(np.abs(np.asarray(mesh.face_normal)), axis=1)
    h = 1.0 / n
    plane = np.rint(fc / h).astype(np.int64)  # plane index along a face's axis
    cell = np.clip(np.floor(fc / h).astype(np.int64), 0, n - 1)
    cen = fc.copy()
    depth = 1.0 / n  # the box's z extent (one cell)
    for a in (0, 1):
        on = axis == a
        cen[on, a] = edges[plane[on, a]]
        cen[~on, a] = mid[cell[~on, a]]
    area = np.where(
        axis == 0, width[cell[:, 1]] * depth,
        np.where(axis == 1, width[cell[:, 0]] * depth,
                 width[cell[:, 0]] * width[cell[:, 1]]),
    )
    cc = np.asarray(mesh.cell_centroid)
    ci = np.clip(np.floor(cc / h).astype(np.int64), 0, n - 1)
    ccell = cc.copy()
    ccell[:, 0], ccell[:, 1] = mid[ci[:, 0]], mid[ci[:, 1]]
    return dict(
        dim=2,
        face_owner=np.asarray(mesh.face_owner),
        face_neighbor=np.where(
            np.asarray(mesh.face_interior), np.asarray(mesh.face_neighbor), -1
        ),
        face_area=area,
        face_normal=np.asarray(mesh.face_normal),
        face_centroid=cen,
        face_zone_slot=np.asarray(mesh.face_zone_slot),
        cell_centroid=ccell,
        cell_volume=width[ci[:, 0]] * width[ci[:, 1]] * depth,
    )


def compiled_both(kw, dtype="f64"):
    """(orc_tpu mesh, port mesh on the CPU) of one set of
    compile_from_arrays arguments."""
    from orc_tpu.mesh.compile import compile_from_arrays as jcompile

    from orc_tpu_torch.mesh.compile import compile_from_arrays as tcompile

    jd, td = DTYPES[dtype]
    return jcompile(**kw, dtype=jd), tcompile(**kw, dtype=td, device="cpu")


def _cavity_table(pkg):
    return _cavity(pkg, 4, DTYPES["f64"][0 if pkg == "jax" else 1])[1]


def _from_arrays(pkg, dtype, kw):
    if pkg == "jax":
        from orc_tpu.mesh.compile import compile_from_arrays

        return compile_from_arrays(**kw, dtype=dtype), _cavity_table(pkg)
    from orc_tpu_torch.mesh.compile import compile_from_arrays

    return compile_from_arrays(**kw, dtype=dtype, device="cpu"), _cavity_table(pkg)


#: name -> make(pkg, jax-or-torch dtype) -> (mesh, table).
CASES = {
    "cavity": lambda pkg, dt: _cavity(pkg, 20, dt),
    "cavity3d": lambda pkg, dt: _cavity(pkg, 8, dt, nz=8),
    "couette": lambda pkg, dt: _channel(pkg, dt, vinlet=False),
    "vinlet": lambda pkg, dt: _channel(pkg, dt, vinlet=True),
}
#: The meshes off the uniform-box path: a permuted 13^2 cavity (RCM +
#: slice plan) and a graded 10^2 box (structured offsets, the expanded
#: CKGeometry), both with the cavity's zone table.
IRREGULAR_CASES = {
    "permuted": lambda pkg, dt: _from_arrays(pkg, dt, permuted_arrays(13, seed=1)[0]),
    "graded": lambda pkg, dt: _from_arrays(pkg, dt, graded_arrays(10)),
}


def both(case: str, dtype: str = "f64"):
    """(jax mesh, jax table), (torch mesh, torch table) of one case."""
    jd, td = DTYPES[dtype]
    make = {**CASES, **IRREGULAR_CASES}[case]
    return make("jax", jd), make("torch", td)


def cell_fields(C: int, seed: int = 3):
    """Seeded vel [C,3], p [C] and a positive momentum diagonal [C]."""
    rng = np.random.default_rng(seed)
    vel = rng.standard_normal((C, 3)) * 0.1
    p = rng.standard_normal(C) * 0.05
    md = rng.uniform(0.5, 2.0, C)
    return vel, p, md


def structured_system(C, offsets, B=0, seed=0):
    """Random diagonally dominant system honoring the offsets contract
    (off == 0 wherever c + d strays outside [0, C)); numpy float64."""
    rng = np.random.default_rng(seed)
    K = len(offsets)
    off = rng.uniform(-1.0, 0.0, size=(C, K))
    c = np.arange(C)
    for k, d in enumerate(offsets):
        if d == 0:
            off[:, k] = 0.0
        else:
            off[((c + d) < 0) | ((c + d) >= C), k] = 0.0
    diag = 1.0 + np.abs(off).sum(axis=1) + rng.random(C)
    shape = (B, C) if B else (C,)
    return diag, off, rng.standard_normal(shape), rng.standard_normal(shape)


# --- files both packages read (I/O, the CLI, the native reader) --------


def chip_smoke():
    """chip_smoke.py as a module (its case_copy and permuted_tgrid)."""
    import importlib.util
    import sys
    from pathlib import Path

    if "chip_smoke" not in sys.modules:
        path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules["chip_smoke"] = module
    return sys.modules["chip_smoke"]


def relabelled_tgrid(tmp_path, n, nz=1, seed=0):
    """A write_tgrid n x n x nz box whose cells are relabelled by a seeded
    permutation (chip_smoke.permuted_tgrid), so that read_mesh takes the
    RCM / slice-plan path: its path."""
    from orc_tpu_torch.mesh.generate import write_tgrid

    box = tmp_path / f"box{n}x{nz}.msh"
    write_tgrid(str(box), n, n, nz, lengths=(1.0, 1.0, 1.0 / n if nz == 1 else 1.0))
    path = tmp_path / f"box{n}x{nz}-relabelled.msh"
    chip_smoke().permuted_tgrid(str(box), str(path), seed=seed)
    return path


def tgrid_2d(path, nx, ny, lengths=(2.0, 1.0)):
    """A genuinely two-dimensional TGRID file ((2 2), 2-node edge faces) of
    an nx x ny quad box: interior, and the four sides as WALL zones."""
    hx, hy = lengths[0] / nx, lengths[1] / ny
    nid = lambda i, j: 1 + i + (nx + 1) * j  # noqa: E731
    cid = lambda i, j: 1 + i + nx * j  # noqa: E731
    zones = {"interior": [], "BOTTOM": [], "TOP": [], "LEFT": [], "RIGHT": []}
    for j in range(ny):
        for i in range(nx + 1):  # vertical edges, owner on the left
            a, b = nid(i, j), nid(i, j + 1)
            if i == 0:
                zones["LEFT"].append((b, a, cid(0, j), 0))
            elif i == nx:
                zones["RIGHT"].append((a, b, cid(nx - 1, j), 0))
            else:
                zones["interior"].append((a, b, cid(i - 1, j), cid(i, j)))
    for j in range(ny + 1):
        for i in range(nx):  # horizontal edges, owner below
            a, b = nid(i, j), nid(i + 1, j)
            if j == 0:
                zones["BOTTOM"].append((a, b, cid(i, 0), 0))
            elif j == ny:
                zones["TOP"].append((b, a, cid(i, ny - 1), 0))
            else:
                zones["interior"].append((b, a, cid(i, j - 1), cid(i, j)))
    n_nodes, n_cells = (nx + 1) * (ny + 1), nx * ny
    out = ['(0 "two-dimensional test mesh")', "(2 2)", f"(10 (0 1 {n_nodes:x} 0 2))",
           f"(10 (1 1 {n_nodes:x} 1 2)("]
    out += [f"{i * hx:.12e} {j * hy:.12e}" for j in range(ny + 1) for i in range(nx + 1)]
    out += ["))", f"(12 (0 1 {n_cells:x} 0))", f"(12 (2 1 {n_cells:x} 1 3))"]
    first = 1
    for zone_id, (name, faces) in enumerate(zones.items(), start=3):
        bc = 2 if name == "interior" else 3
        last = first + len(faces) - 1
        out += [f'(0 "faces of zone {name}")', f"(13 ({zone_id:x} {first:x} {last:x} {bc:x} 2)("]
        out += [" ".join(f"{v:x}" for v in f) for f in faces]
        out += ["))"]
        first = last + 1
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path
