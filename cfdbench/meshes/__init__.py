"""Meshes the benchmark generates, as users would bring them: plain numpy
generators (one module each, `generate(**params) -> Grid`) and the ASCII
TGRID writer (tgrid.py) whose files the program reads through its own
case path. Nothing here imports the program."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Grid:
    """A face list as a TGRID file holds it, 0-based.

    points [N, 3] float64 (z = 0 in 2-D); face_nodes [F, M] the M nodes of
    each face, in the order the file lists them; face_cells [F, 2] the
    face's two cells, the first always present (the owner), -1 for none;
    face_zone [F] an index into `zones`, [(name, TGRID condition code)],
    faces of one zone contiguous and the zones in file order; `cell_ijk`
    [C, 3] the box position of each cell where the generator has one
    (tests map box fields through it)."""

    dim: int
    points: np.ndarray
    face_nodes: np.ndarray
    face_cells: np.ndarray
    face_zone: np.ndarray
    zones: list
    n_cells: int
    cell_ijk: np.ndarray | None = None

    @property
    def n_faces(self) -> int:
        return self.face_nodes.shape[0]


def generator(name: str):
    """The generator module `cfdbench.meshes.<name>`."""
    import importlib

    return importlib.import_module(f"cfdbench.meshes.{name}")
