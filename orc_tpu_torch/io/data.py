"""Text-format solution I/O (port of orc_tpu/io/data.py), byte-identical
to orc_tpu's files for the same arrays.

Format (reference: io.rs:573-662): one line per cell,

    (cx, cy, cz)\t(u, v, w)\tp              -- data file
    (cx, cy, cz)\t(g11, ..., g33)\t(gx, gy, gz)  -- gradients file

with Rust-style lower-exponent floats (``1.56e-4``: no '+', no
zero-padded exponent), which is what the reference plotter's regex
`[\\d|\\.|e|\\-]+` accepts (plot_output.py:139-141).

Tensors are copied to host numpy at their own dtype and every value is
formatted in a Python loop, as orc_tpu does, so a float32 field prints
exactly the digits orc_tpu prints for it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """numpy copy of a tensor (at its dtype) or an array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rust_sci(x: float, precision: int = 6) -> str:
    """Format like Rust's `{:.Ne}`: `-1.50e-4`, `0.00e0`."""
    s = f"{x:.{precision}e}"
    m, e = s.split("e")
    return f"{m}e{int(e)}"


def _vec(v, precision) -> str:
    return "(" + ", ".join(rust_sci(c, precision) for c in v) + ")"


def _raw_order_inv(mesh):
    """Permutation mapping compiled-order arrays to the raw-file cell
    order, or None when the compile kept the input order. The text
    formats' implicit schema is the RAW mesh order (io.rs:519-571), so
    RCM-compiled meshes must not leak their internal ordering into the
    files."""
    order = getattr(mesh, "cell_order", None)
    if order is None:
        return None
    order = _host(order)
    inv = np.empty(order.shape[0], dtype=np.int64)
    inv[order] = np.arange(order.shape[0])
    return inv


def write_data(path, mesh, vel, p, precision: int = 6):
    """Write the per-cell solution (reference: io.rs:573-620).

    `vel`: [C,3]; `p`: [C]. Centroids always use 2-decimal precision as
    the reference's Vector Display impl does (lib.rs:551-556). Rows are
    emitted in raw-mesh cell order (the format's implicit schema).
    """
    cc = _host(mesh.cell_centroid)
    vel = _host(vel)
    p = _host(p)
    inv = _raw_order_inv(mesh)
    if inv is not None:
        cc, vel, p = cc[inv], vel[inv], p[inv]
    with open(path, "w") as f:
        for c in range(cc.shape[0]):
            f.write(
                f"{_vec(cc[c], 2)}\t{_vec(vel[c], precision)}\t"
                f"{rust_sci(p[c], precision)}\n"
            )


def read_data(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read a solution file -> (vel [C,3], p [C]) as float64 numpy
    (reference: io.rs:519-571: the centroid column is ignored; cell
    order is the implicit schema)."""
    vel = []
    p = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            cols = line.split("\t")
            if len(cols) != 3:
                raise ValueError(
                    f"expected 3 tab-separated columns, got {len(cols)}"
                )
            uvw = cols[1].strip().lstrip("(").rstrip(")").split(",")
            vel.append([float(x) for x in uvw])
            p.append(float(cols[2]))
    return np.asarray(vel), np.asarray(p)


def write_face_velocities(path, mesh, face_vel, precision: int = 6):
    """Write per-FACE velocities for the multi-file comparison plot
    (plotting.plot_face_velocities; reference consumer:
    plot_output.py:220-260: rows `id\\t(x, y, z)\\t(u, v, w)`).

    `face_vel`: [F,3] face velocity vectors (e.g.
    ops.interpolation.face_velocity). Faces keep mesh order: the id
    column is informational, like the reference format's."""
    fc = _host(mesh.face_centroid)
    fv = _host(face_vel)
    with open(path, "w") as f:
        for i in range(fc.shape[0]):
            f.write(
                f"{i}\t{_vec(fc[i], precision)}\t"
                f"{_vec(fv[i], precision)}\n"
            )


def write_gradients(path, mesh, grad_vel, grad_p, precision: int = 7):
    """Write per-cell velocity (9 components, row-major) and pressure
    (3 components) gradients (reference: io.rs:622-662)."""
    cc = _host(mesh.cell_centroid)
    gv = _host(grad_vel).reshape(cc.shape[0], 9)
    gp = _host(grad_p)
    inv = _raw_order_inv(mesh)
    if inv is not None:
        cc, gv, gp = cc[inv], gv[inv], gp[inv]
    with open(path, "w") as f:
        for c in range(cc.shape[0]):
            f.write(
                f"{_vec(cc[c], 2)}\t{_vec(gv[c], precision)}\t"
                f"{_vec(gp[c], precision)}\n"
            )
