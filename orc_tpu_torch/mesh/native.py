"""ctypes bindings for the native TGRID parser (port of
orc_tpu/mesh/native.py).

The port keeps its own copy of the C++ parser, `csrc/tgrid_reader.cpp`
(host code, built with g++, not nvcc). `library()` builds it at first
use into ``build/orc_tpu_torch/libtgrid.so`` beside the package, under a
file lock so that concurrent processes build it once; a source newer
than the library triggers a rebuild. A failed build raises with g++'s
stderr. `parse_tgrid_native(path) -> RawMesh` parses a file with it;
`read_mesh(native=...)` chooses between it and the Python parser.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import shutil
import subprocess

import numpy as np

from orc_tpu_torch.mesh.tgrid import RawMesh
from orc_tpu_torch.mesh.zones import FaceCondition, FaceZone
from orc_tpu_torch.ops._cuda import BUILD_DIR, CSRC_DIR

SRC = CSRC_DIR / "tgrid_reader.cpp"
LIB_PATH = BUILD_DIR / "libtgrid.so"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")


def is_stale() -> bool:
    """True when the library is missing or older than its source."""
    return (
        not LIB_PATH.exists()
        or LIB_PATH.stat().st_mtime < SRC.stat().st_mtime
    )


def build() -> None:
    """Compile csrc/tgrid_reader.cpp into LIB_PATH with g++. Raises
    RuntimeError with the compiler's stderr on failure."""
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ is not on PATH: the native TGRID reader cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libtgrid.{os.getpid()}.tmp.so"
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cxx} failed with exit code {proc.returncode} building "
                f"{SRC}:\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)


def _build_locked() -> None:
    """Build unless another process did meanwhile (the lock file is
    released when its holder exits, so a killed build leaves no stale
    lock)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libtgrid.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if is_stale():
                build()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded parser library, built first if stale."""
    if is_stale():
        _build_locked()
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.tgrid_parse.restype = ctypes.c_void_p
    lib.tgrid_parse.argtypes = [ctypes.c_char_p]
    lib.tgrid_error.restype = ctypes.c_char_p
    lib.tgrid_error.argtypes = []
    lib.tgrid_dim.restype = ctypes.c_int
    lib.tgrid_dim.argtypes = [ctypes.c_void_p]
    for fn in (
        "tgrid_n_points",
        "tgrid_n_faces",
        "tgrid_n_cells",
        "tgrid_total_face_nodes",
        "tgrid_n_periodic",
    ):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    ip = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    lib.tgrid_points.restype = None
    lib.tgrid_points.argtypes = [ctypes.c_void_p, dp]
    for fn in (
        "tgrid_face_counts",
        "tgrid_face_nodes",
        "tgrid_face_cells",
        "tgrid_face_zone",
        "tgrid_periodic_pairs",
    ):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ip]
    lib.tgrid_n_zones.restype = ctypes.c_int
    lib.tgrid_n_zones.argtypes = [ctypes.c_void_p]
    lib.tgrid_zone_info.restype = None
    lib.tgrid_zone_info.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.tgrid_free.restype = None
    lib.tgrid_free.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the parser library builds (or is built) and loads here."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def parse_tgrid_native(path: str) -> RawMesh:
    """Parse a TGRID file with the C++ reader: the RawMesh the Python
    parser gives, without cell zones. Raises ValueError on a malformed
    file and RuntimeError when the library cannot be built."""
    lib = library()
    h = lib.tgrid_parse(os.fsencode(path))
    if not h:
        raise ValueError(
            f"native TGRID parse failed: "
            f"{lib.tgrid_error().decode() or 'unknown error'}"
        )
    try:
        dim = lib.tgrid_dim(h)
        n_pts = lib.tgrid_n_points(h)
        n_faces = lib.tgrid_n_faces(h)
        n_cells = lib.tgrid_n_cells(h)
        total_nodes = lib.tgrid_total_face_nodes(h)

        points = np.empty((n_pts, 3), dtype=np.float64)
        lib.tgrid_points(h, points.reshape(-1))
        counts = np.empty(n_faces, dtype=np.int64)
        lib.tgrid_face_counts(h, counts)
        nodes_flat = np.empty(total_nodes, dtype=np.int64)
        lib.tgrid_face_nodes(h, nodes_flat)
        face_cells = np.empty(n_faces * 2, dtype=np.int64)
        lib.tgrid_face_cells(h, face_cells)
        face_zone = np.empty(n_faces, dtype=np.int64)
        lib.tgrid_face_zone(h, face_zone)
        n_per = lib.tgrid_n_periodic(h)
        periodic_pairs = np.empty(max(n_per, 1) * 2, dtype=np.int64)
        if n_per:
            lib.tgrid_periodic_pairs(h, periodic_pairs)
        periodic_pairs = periodic_pairs[: n_per * 2].reshape(n_per, 2)

        face_zones = {}
        name_buf = ctypes.create_string_buffer(256)
        for i in range(lib.tgrid_n_zones(h)):
            zid = ctypes.c_int64()
            bc = ctypes.c_int64()
            lib.tgrid_zone_info(
                h, i, ctypes.byref(zid), ctypes.byref(bc), name_buf, 256
            )
            face_zones[int(zid.value)] = FaceZone(
                zone_id=int(zid.value),
                zone_type=FaceCondition(int(bc.value)),
                name=name_buf.value.decode(),
            )
    finally:
        lib.tgrid_free(h)

    offsets = np.zeros(n_faces + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    face_nodes = [
        nodes_flat[offsets[i] : offsets[i + 1]] for i in range(n_faces)
    ]
    return RawMesh(
        dim=dim,
        points=points,
        face_nodes=face_nodes,
        face_cells=face_cells.reshape(n_faces, 2),
        face_zone_id=face_zone,
        face_zones=face_zones,
        cell_zones={},
        n_cells=int(n_cells),
        periodic_pairs=periodic_pairs,
    )
