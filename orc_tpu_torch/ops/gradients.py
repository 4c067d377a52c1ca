"""Least-squares cell gradients (port of orc_tpu/ops/gradients.py
`_least_squares`).

Each cell solves its normal equations (A^T A) g = A^T b over its ELL
slots: d [C,K,3] the displacement rows, b the value deltas, masked rows
zeroed by the caller. 2-D meshes drop the z column statically and pad
it back with zeros.

The dim x dim solves are closed forms (Cramer's rule on the symmetric
Gram matrix, its entries summed over the slots): plain elementwise
tensor arithmetic, with no pivoting and no singularity check, so no
device-to-host sync on the card (orc_tpu's `jnp.linalg.solve` never
raises either). The Gram matrix of a cell with at least `dim`
independent rows is symmetric positive definite, where the closed form
agrees with orc_tpu's LU solve to roundoff.

Not ported yet: the face-major `pressure_gradient` / `velocity_gradient`
and node-based Green-Gauss (ROADMAP Queue 1, the face-major half of
items 3+5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gram(dd):
    """The unique entries {(a, b): [C]}, a <= b, of each cell's Gram
    matrix sum_k d_a d_b of its rows dd [C,K,dim]."""
    n = dd.shape[-1]
    return {
        (a, c): torch.sum(dd[..., a] * dd[..., c], dim=1)
        for a in range(n) for c in range(a, n)
    }


def _cramer(g, r):
    """x of G x = r by Cramer's rule, G symmetric n x n (n <= 3) given by
    its unique entries g {(a, b): tensor}, r a list of n right-hand
    sides broadcasting against them; returns the n components of x."""
    n = len(r)
    if n == 1:
        return [r[0] / g[0, 0]]
    if n == 2:
        g00, g01, g11 = g[0, 0], g[0, 1], g[1, 1]
        det = g00 * g11 - g01 * g01
        return [(g11 * r[0] - g01 * r[1]) / det, (g00 * r[1] - g01 * r[0]) / det]
    g00, g01, g02 = g[0, 0], g[0, 1], g[0, 2]
    g11, g12, g22 = g[1, 1], g[1, 2], g[2, 2]
    c00 = g11 * g22 - g12 * g12
    c01 = g02 * g12 - g01 * g22
    c02 = g01 * g12 - g02 * g11
    c11 = g00 * g22 - g02 * g02
    c12 = g01 * g02 - g00 * g12
    c22 = g00 * g11 - g01 * g01
    det = g00 * c00 + g01 * c01 + g02 * c02
    return [
        (c00 * r[0] + c01 * r[1] + c02 * r[2]) / det,
        (c01 * r[0] + c11 * r[1] + c12 * r[2]) / det,
        (c02 * r[0] + c12 * r[1] + c22 * r[2]) / det,
    ]


def least_squares(dim: int, d, b):
    """Per-cell least-squares gradient: d [C,K,3] displacement rows, b
    [C,K] or [C,K,3] value deltas (masked rows zeroed). Returns [C,3] or
    [C,3,3] (row i = gradient of component i). The normal equations are
    formed as per-cell sums over the K slots: as a batched matrix product
    the pressure gradient of the 1024^2 f32 cavity took 4.27 ms on an
    NVIDIA H100 80GB HBM3 (700 W), as slot sums 1.31 ms."""
    dd = d[..., :dim]
    g = _gram(dd)
    if b.ndim == 2:
        r = [torch.sum(dd[..., a] * b, dim=1) for a in range(dim)]  # [C]
        x = torch.stack(_cramer(g, r), dim=-1)  # [C,dim]
    else:
        r = [torch.sum(dd[..., a, None] * b, dim=1) for a in range(dim)]  # [C,3]
        gv = {key: v[:, None] for key, v in g.items()}
        x = torch.stack(_cramer(gv, r), dim=-1)  # [C,3,dim]
    return F.pad(x, (0, 3 - dim)) if dim < 3 else x
