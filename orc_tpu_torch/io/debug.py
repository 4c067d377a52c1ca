"""Human-readable dumps of assembled systems (port of
orc_tpu/io/debug.py, a debug aid).

Counterpart of the reference's matrix/vector pretty-printers
(io.rs:666-820): small systems print densely with aligned columns;
large systems print per-row sparse entries with the diagonal starred.
Operates on the port's ELL matrices (orc_tpu_torch.ops.spmv.EllMatrix)
and gives orc_tpu's strings for the same values.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def vector_to_string(v) -> str:
    v = _host(v)
    return "[" + ", ".join(f"{x: >9.2e}" for x in v) + "]"


def print_vec_scientific(v):
    print(vector_to_string(v))


def ell_to_string(A, max_dense_cols: int = 16) -> str:
    """Render an EllMatrix; dense layout below `max_dense_cols`.

    `off` may be [C,K] or split into K [C] columns
    (EllMatrix.split_columns). Structured-mesh matrices may omit
    `neighbors` (the shift-SpMV path never reads it); the column targets
    are reconstructed from the static offsets, clipped to in-range rows
    (out-of-range shifts carry zero coefficients by the EllMatrix.offsets
    contract)."""
    diag = _host(A.diag)
    if isinstance(A.off, tuple):
        off = np.stack([_host(c) for c in A.off], axis=-1)
    else:
        off = _host(A.off)
    n = diag.shape[-1]
    if A.neighbors is not None:
        nbr = _host(A.neighbors)
    else:
        idx = np.arange(n)[:, None]
        deltas = np.asarray(A.offsets, dtype=np.int64)[None, :]
        nbr = np.clip(idx + deltas, 0, n - 1)
    rows = []
    if n < max_dense_cols:
        dense = np.zeros((n, n))
        for i in range(n):
            dense[i, i] = diag[i]
            for k in range(off.shape[-1]):
                dense[i, nbr[i, k]] += off[i, k]
        for i in range(n):
            cells = [
                f"{dense[i, j]: <9.2e}" if dense[i, j] != 0 else " " * 9
                for j in range(n)
            ]
            rows.append(f"{i}: " + ", ".join(cells))
    else:
        for i in range(n):
            ent = [f"*{i}={diag[i]:.2e}"]
            for k in range(off.shape[-1]):
                if off[i, k] != 0.0:
                    ent.append(f"{nbr[i, k]}={off[i, k]:.2e}")
            rows.append(f"{i}: " + ", ".join(ent))
    return "\n".join(rows)


def linear_system_to_string(A, b, max_dense_cols: int = 16) -> str:
    """Matrix rows alongside the RHS."""
    b = _host(b)
    lines = ell_to_string(A, max_dense_cols).split("\n")
    return "\n".join(
        f"{line} | {b[i]: >9.2e}" for i, line in enumerate(lines)
    )


def print_matrix(A):
    print(ell_to_string(A))


def print_linear_system(A, b):
    print(linear_system_to_string(A, b))
