"""Build, load and call the port's CUDA kernels.

Every source under ``orc_tpu_torch/csrc/`` compiles for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together,
and the objects link into a shared library with a plain C interface,
``build/orc_tpu_torch/liborc_tpu_torch.so`` beside the package, at first
use; a source newer than the library triggers a rebuild. ptxas reports
each kernel's registers and spills into ``build/orc_tpu_torch/ptxas.log``.
The library is loaded with ctypes. A failed build raises with nvcc's
stderr and a failed load raises the loader's error: there is no fallback
to another implementation.

Each C entry point takes the dtype code, device pointers and the CUDA
stream as ``void*``, launches on that stream without synchronising, and
returns ``cudaGetLastError()``; `call` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "orc_tpu_torch"
LIB_PATH = BUILD_DIR / "liborc_tpu_torch.so"
PTXAS_LOG = BUILD_DIR / "ptxas.log"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
#: Kernel-argument capacity for ELL columns (csrc/common.cuh MAX_K).
MAX_K = 8

DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

_p = ctypes.c_void_p
_pp = ctypes.POINTER(ctypes.c_void_p)
_i = ctypes.c_int
_ll = ctypes.c_longlong
_pll = ctypes.POINTER(ctypes.c_longlong)
_d = ctypes.c_double
_pd = ctypes.POINTER(ctypes.c_double)
_pi = ctypes.POINTER(ctypes.c_int)

#: C signatures (the stream is the last argument of every entry point).
SIGNATURES = {
    # dtype, diag, cols, col_strides, offsets, K, x, y, C, B, stream
    "orc_shift_spmv": (_i, _p, _pp, _pll, _pll, _i, _p, _p, _ll, _i, _p),
    # dtype, diag, diag batch stride, cols, col_strides, col batch
    # strides, offsets, K, x, y, C, B, stream
    "orc_shift_spmv_rows": (
        _i, _p, _ll, _pp, _pll, _pll, _pll, _i, _p, _p, _ll, _i, _p,
    ),
    # dtype, diag, cols, col_strides, offsets, K, b, x0, buf0, buf1, C,
    # B, sweeps, relaxation, nx, ny, nz, depth, bx, by, bz, stream
    "orc_jacobi_sweeps": (
        _i, _p, _pp, _pll, _pll, _i, _p, _p, _p, _p, _ll, _i, _i, _d, _ll,
        _ll, _ll, _i, _i, _i, _i, _p,
    ),
    # dtype, diag, diag batch stride, cols, col_strides, col batch
    # strides, offsets, K, b, x0, buf0, buf1, C, B, sweeps, relaxation,
    # nx, ny, nz, depth, bx, by, bz, stream
    "orc_jacobi_sweeps_rows": (
        _i, _p, _ll, _pp, _pll, _pll, _pll, _i, _p, _p, _p, _p, _ll, _i, _i,
        _d, _ll, _ll, _ll, _i, _i, _i, _i, _p,
    ),
    # dtype, diag, cols, col_strides, offsets, K, b, x0, buf0, buf1, C,
    # B, sweeps, relaxation, nx, ny, nz, depth, bx, by, bz, stream
    "orc_jacobi_march": (
        _i, _p, _pp, _pll, _pll, _i, _p, _p, _p, _p, _ll, _i, _i, _d, _ll,
        _ll, _ll, _i, _i, _i, _i, _p,
    ),
    # dtype, scheme, limiter, rc, p_so, gg, col_offsets, col_geom[K*6],
    # col_kind, col_zone, K, nx, ny, nz, row0, vel, p, grad_p, mom_diag,
    # grad_vel, rv_dt, vel_n, bc, flags, rho, mu, alpha, vol, diag, off,
    # b, C, stream
    "orc_momentum_assembly": (
        _i, _i, _i, _i, _i, _i, _pll, _pd, _pi, _pi, _i, _ll, _ll, _ll, _ll, _p,
        _p, _p, _p, _p, _p, _p, _p, _p, _d, _d, _d, _d, _p, _p, _p, _ll, _p,
    ),
    # dtype, rc, gg, col_offsets, col_geom[K*6], col_kind, col_zone, K,
    # nx, ny, nz, row0, vel, mom_diag, p, grad_p, bc, flags, rho, vol,
    # diag, off, b, C, stream
    "orc_pc_assembly": (
        _i, _i, _i, _pll, _pd, _pi, _pi, _i, _ll, _ll, _ll, _ll, _p, _p, _p, _p,
        _p, _p, _d, _d, _p, _p, _p, _ll, _p,
    ),
    # dtype, scheme, limiter, p_so, col_offsets, col_geom[K*6], col_kind,
    # col_zone, K, nx, ny, nz, row0, vel, p, flux planes, grad_p,
    # grad_vel, rv_dt, vel_n, bc, flags, rho, mu, alpha, diag, off, b, C,
    # stream
    "orc_fc_momentum_assembly": (
        _i, _i, _i, _i, _pll, _pd, _pi, _pi, _i, _ll, _ll, _ll, _ll, _p, _p, _p,
        _p, _p, _p, _p, _p, _p, _d, _d, _d, _p, _p, _p, _ll, _p,
    ),
    # dtype, rc, col_offsets, col_geom[K*6], col_kind, col_zone, K, nx,
    # ny, nz, row0, vel, mom_diag, grad_p, bc, flags, rho, vol, diag, off,
    # b, flux_h, C, stream
    "orc_fc_pc_assembly": (
        _i, _i, _pll, _pd, _pi, _pi, _i, _ll, _ll, _ll, _ll, _p, _p, _p, _p,
        _p, _d, _d, _p, _p, _p, _p, _ll, _p,
    ),
    # dtype, scheme, limiter, K, weighted, implicit, the 26 pointers of
    # csrc/fm_assembly.cu (inputs, then diag, off, b, pe), rho,
    # (1 - alpha) / alpha, alpha, C, stream
    "orc_fm_momentum_assembly": (
        _i, _i, _i, _i, _i, _i, _pp, _d, _d, _d, _ll, _p,
    ),
    # dtype, diag, diag batch stride, coef, coef batch stride, starts,
    # tile_nj, x, y, C, tile, ntiles, n_max, pad_lo, B, stream
    "orc_slice_spmv": (
        _i, _p, _ll, _p, _ll, _p, _p, _p, _p, _ll, _i, _ll, _i, _ll, _i, _p,
    ),
    # coef, coef batch stride, starts, tile_nj, x, y, err, C, tile,
    # ntiles, n_max, pad_lo, B, stream (float32 only)
    "orc_slice_spmv_exact": (
        _p, _ll, _p, _p, _p, _p, _p, _ll, _i, _ll, _i, _ll, _i, _p,
    ),
    # dtype, x, interior, starts, col_tile, out, C, K, F, tile, n_max,
    # pad_lo, stream
    "orc_slice_nbr": (_i, _p, _p, _p, _p, _p, _ll, _i, _i, _i, _i, _ll, _p),
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def is_stale() -> bool:
    """True when the library is missing or older than a source."""
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _sources())


def _run(cmds):
    """Run the commands concurrently and wait for all of them; raise
    RuntimeError with the output of the first that failed. Returns
    their stderr."""
    procs = [
        subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        for cmd in cmds
    ]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{err}{out}"
            )
    return [err for _out, err in outs]


def build() -> float:
    """Compile every csrc/*.cu (in parallel) and link the library;
    returns the seconds nvcc took. Raises RuntimeError with nvcc's
    stderr on failure."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the "
            "port's CUDA kernels cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objects = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    tmp = BUILD_DIR / f"liborc_tpu_torch.{tag}.tmp.so"
    t0 = time.perf_counter()
    try:
        logs = _run([
            [nvcc, *NVCC_FLAGS, "-Xptxas=-v", f"-I{CSRC_DIR}", "-c",
             "-o", str(o), str(s)]
            for s, o in zip(sources, objects)
        ])
        PTXAS_LOG.write_text("".join(logs))
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objects)]])
    finally:
        for o in objects:
            o.unlink(missing_ok=True)
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if stale."""
    if is_stale():
        build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.orc_error_string.argtypes = (ctypes.c_int,)
    lib.orc_error_string.restype = ctypes.c_char_p
    return lib


def call(name: str, device: torch.device, *args) -> None:
    """Run C entry point `name` on `device`'s current stream; raise if
    it reports a CUDA error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.orc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(
            f"the CUDA kernels take float32 or float64, got {t.dtype}"
        )
    return DTYPE_CODES[t.dtype]


def column_args(columns, offsets):
    """ctypes arrays (pointers, element strides along the rows, offsets)
    for K [C] (or per-row [B,C]) column tensors; the caller keeps
    `columns` alive over the call."""
    K = len(columns)
    if K > MAX_K:
        raise ValueError(f"at most {MAX_K} ELL columns, got {K}")
    ptrs = (ctypes.c_void_p * max(K, 1))(*(c.data_ptr() for c in columns))
    strides = (ctypes.c_longlong * max(K, 1))(*(c.stride(-1) for c in columns))
    offs = (ctypes.c_longlong * max(K, 1))(*(int(d) for d in offsets))
    return ptrs, strides, offs


def batch_strides(columns):
    """ctypes array of the batch-row strides of K per-row [B,C] column
    tensors."""
    return (ctypes.c_longlong * max(len(columns), 1))(
        *(c.stride(0) for c in columns)
    )


def check_cuda(device: torch.device, **tensors) -> None:
    """Raise unless every tensor lies on `device`."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(
                f"{name} is on {t.device}, expected {device}"
            )
