"""Boundary-condition zone model (port of orc_tpu/mesh/zones.py).

Host-side numpy, as in orc_tpu: Fluent TGRID face-condition codes, the
per-zone `BoundaryTable`, and the set of conditions with a solver path.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Tuple

import numpy as np


class FaceCondition(enum.IntEnum):
    """Fluent TGRID boundary-condition codes."""

    INTERIOR = 2
    WALL = 3
    PRESSURE_INLET = 4
    PRESSURE_OUTLET = 5
    SYMMETRY = 7
    PERIODIC_SHADOW = 8
    PRESSURE_FAR_FIELD = 9
    VELOCITY_INLET = 10
    PERIODIC = 12
    POROUS_JUMP = 14
    MASS_FLOW_INLET = 20
    INTERFACE = 24
    PARENT = 31
    OUTFLOW = 36
    AXIS = 37


#: Face conditions with a solver path. Periodic pairs are merged into
#: interior faces when the mesh is built.
SUPPORTED_CONDITIONS = frozenset(
    {
        FaceCondition.INTERIOR,
        FaceCondition.WALL,
        FaceCondition.PRESSURE_INLET,
        FaceCondition.PRESSURE_OUTLET,
        FaceCondition.SYMMETRY,
        FaceCondition.VELOCITY_INLET,
        FaceCondition.PERIODIC,
        FaceCondition.PERIODIC_SHADOW,
    }
)

#: Cell-zone type codes.
CELL_ZONE_TYPES = {0: "dead zone", 1: "fluid zone", 17: "solid zone"}


@dataclasses.dataclass
class FaceZone:
    """A named group of faces sharing one boundary condition."""

    zone_id: int
    zone_type: FaceCondition
    name: str = ""
    scalar_value: float = 0.0  # e.g. boundary pressure
    vector_value: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # e.g. wall velocity


@dataclasses.dataclass
class CellZone:
    zone_id: int
    zone_type: int  # CELL_ZONE_TYPES code
    name: str = ""


class BoundaryTable:
    """Per-zone BC arrays, indexed by a dense zone slot (0..Z-1, the
    sorted zone ids). `codes` is a tuple; `scalar` [Z] and `vector`
    [Z,3] are float64 numpy arrays moved to the device by
    ops.fields.device_bc."""

    def __init__(self, zones: Dict[int, FaceZone]):
        self.zone_ids = sorted(zones)
        self.slot_of_zone = {zid: i for i, zid in enumerate(self.zone_ids)}
        self.zones = dict(zones)
        self._rebuild()

    def _rebuild(self):
        z = len(self.zone_ids)
        self.codes = tuple(
            int(self.zones[zid].zone_type) for zid in self.zone_ids
        )
        self.scalar = np.zeros((z,), dtype=np.float64)
        self.vector = np.zeros((z, 3), dtype=np.float64)
        for i, zid in enumerate(self.zone_ids):
            fz = self.zones[zid]
            self.scalar[i] = fz.scalar_value
            self.vector[i] = np.asarray(fz.vector_value, dtype=np.float64)

    def zone_by_name(self, name: str) -> FaceZone:
        for fz in self.zones.values():
            if fz.name == name:
                return fz
        raise KeyError(
            f"face zone '{name}' not found; zones: "
            f"{[fz.name for fz in self.zones.values()]}"
        )

    def set(
        self,
        name: str,
        zone_type: FaceCondition | None = None,
        scalar_value: float | None = None,
        vector_value=None,
    ) -> "BoundaryTable":
        """Update one zone in place (chainable)."""
        fz = self.zone_by_name(name)
        if zone_type is not None:
            fz.zone_type = FaceCondition(zone_type)
        if scalar_value is not None:
            fz.scalar_value = float(scalar_value)
        if vector_value is not None:
            fz.vector_value = tuple(float(c) for c in vector_value)
        self._rebuild()
        return self

    def validate_supported(self):
        for fz in self.zones.values():
            if fz.zone_type not in SUPPORTED_CONDITIONS:
                raise NotImplementedError(
                    f"face zone '{fz.name}' has condition {fz.zone_type!r}, "
                    f"which has no solver path (supported: "
                    f"{sorted(c.name for c in SUPPORTED_CONDITIONS)})"
                )
