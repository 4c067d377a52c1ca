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

    return cavity_case(n=n, nz=nz, dtype=dtype)


def _channel(pkg, dtype, vinlet: bool):
    if pkg == "jax":
        from orc_tpu.mesh.generate import structured_box_mesh

        fc = JFaceCondition
    else:
        from orc_tpu_torch.mesh.generate import structured_box_mesh

        fc = FaceCondition
    mesh, table = structured_box_mesh(
        16, 8, 1, lengths=(0.002, 0.001, 0.0001), dtype=dtype
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


#: name -> make(pkg, jax-or-torch dtype) -> (mesh, table).
CASES = {
    "cavity": lambda pkg, dt: _cavity(pkg, 20, dt),
    "cavity3d": lambda pkg, dt: _cavity(pkg, 8, dt, nz=8),
    "couette": lambda pkg, dt: _channel(pkg, dt, vinlet=False),
    "vinlet": lambda pkg, dt: _channel(pkg, dt, vinlet=True),
}


def both(case: str, dtype: str = "f64"):
    """(jax mesh, jax table), (torch mesh, torch table) of one case."""
    jd, td = DTYPES[dtype]
    return CASES[case]("jax", jd), CASES[case]("torch", td)


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
