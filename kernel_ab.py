"""Time the structured stencil SpMV, the Jacobi sweeps, the slice-plan
SpMV and its exact product, the neighbour gather and the assembly
kernels (parity momentum and pressure correction, SIMPLE_FC momentum and
pressure) of two versions of their CUDA sources in one process on one
GPU.

Usage (from the repository root, on a machine with a CUDA GPU):

    git archive <commit> orc_tpu_torch/csrc | tar -x -C build/ab_base
    python3 kernel_ab.py build/ab_base/orc_tpu_torch/csrc [--reps 3]

It builds ``shift_spmv.cu``, ``jacobi_sweeps.cu``, ``slice_spmv.cu``,
``parity_assembly.cu``, ``parity_assembly_f64.cu`` and ``assembly.cu`` of
the base directory and of
``orc_tpu_torch/csrc`` into two libraries (one nvcc per source, sm_90a,
all in parallel) and, at the shapes chip_smoke.py times, checks that
both agree with the plain torch versions (the gather bitwise) and
reports whether they agree with each other bit for bit, then times each
on the card alone (calls queued behind a sleeping kernel,
chip_smoke.card_ms) in the order base, new, new, base, `--reps` times,
with the one PyTorch call computing the same function beside them where
there is one, warm and with L2 emptied first. Prints one line per shape
and writes every time to chiprun_out/kernel_ab.json.

Group `fm` times the face-major momentum kernel (fm_assembly.cu) of the
tree's version in turns against the plain face_pressure +
momentum_system it replaces; a base version without the source builds
without it.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import importlib.util
import json
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SOURCES = ("shift_spmv.cu", "jacobi_sweeps.cu", "slice_spmv.cu",
           "parity_assembly.cu", "parity_assembly_f64.cu", "assembly.cu",
           "fm_assembly.cu")
#: The kernels whose ptxas registers and spills the log lists
#: ("momentum_kernel" names fc_momentum_kernel too).
REPORTED = ("slice_spmv_kernel", "slice_spmv_exact_kernel", "momentum_kernel",
            "pc_kernel", "pc_gg_kernel", "jacobi_tile_kernel", "jacobi_sweep_kernel",
            "jacobi_march_kernel")
#: The entry points that take the box's (nx, ny, nz), each with the
#: position of nx among its arguments and the count of the arguments
#: that came with it (the Jacobi sweeps' also take the depth and the
#: tile, the assembly kernels' the box's first row, row0): a base
#: version whose entry point takes none (the versions before the
#: kernel's box tiles) is called without them, one that takes the box
#: but no row0 (before the sharded runtime's windows) without row0.
BOXED = {"orc_momentum_assembly": (11, 4), "orc_pc_assembly": (8, 4),
         "orc_fc_momentum_assembly": (9, 4), "orc_fc_pc_assembly": (7, 4),
         "orc_jacobi_sweeps": (14, 7), "orc_jacobi_sweeps_rows": (16, 7)}


def build(csrc: Path, out: Path):
    """(nvcc commands compiling SOURCES of `csrc` into objects beside
    library `out`, the command linking them)."""
    from orc_tpu_torch.ops import _cuda

    nvcc = "/usr/local/cuda/bin/nvcc"
    sources = [s for s in SOURCES if (csrc / s).exists()]  # older csrc lacks some
    objs = [out.with_name(f"{out.stem}.{Path(s).stem}.o") for s in sources]
    compiles = [[nvcc, *_cuda.NVCC_FLAGS, "-Xptxas=-v", f"-I{csrc}", "-c",
                 "-o", str(o), str(csrc / s)] for s, o in zip(sources, objs)]
    link = [nvcc, *_cuda.NVCC_FLAGS, "-shared", "-o", str(out), *map(str, objs)]
    return compiles, link


class Version:
    """One build of the sources: its library and which of its entry
    points take the box's (nx, ny, nz) and which its row0 too."""

    def __init__(self, path: Path, csrc: Path):
        from orc_tpu_torch.ops import _cuda

        self.lib = ctypes.CDLL(str(path))
        text = "".join((csrc / s).read_text()
                       for s in ("parity_assembly.cu", "assembly.cu", "jacobi_sweeps.cu"))
        params = {
            name: re.search(rf"{name}\((.*?)\)", text, re.S).group(1) for name in BOXED
        }
        self.boxed = {name for name in BOXED if "long long nx" in params[name]}
        self.row0 = {name for name in BOXED if "long long row0" in params[name]}
        # Older versions have no z-march and no face-major assembly.
        self.march = hasattr(self.lib, "orc_jacobi_march")
        self.fm = hasattr(self.lib, "orc_fm_momentum_assembly")
        for name in ("orc_shift_spmv", "orc_slice_nbr", "orc_slice_spmv",
                     "orc_slice_spmv_exact", "orc_jacobi_sweeps",
                     "orc_jacobi_sweeps_rows", "orc_momentum_assembly",
                     "orc_pc_assembly", "orc_fc_momentum_assembly",
                     "orc_fc_pc_assembly") + ("orc_jacobi_march",) * self.march + (
                         "orc_fm_momentum_assembly",) * self.fm:
            fn = getattr(self.lib, name)
            fn.argtypes = self.unboxed(name, _cuda.SIGNATURES[name])
            fn.restype = ctypes.c_int

    def unboxed(self, name, args):
        """`args` of `name` without (nx, ny, nz, row0) where this
        version's entry point takes no box, without row0 where it takes
        the box alone."""
        if name in BOXED and name not in self.boxed:
            at, n = BOXED[name]
            return args[:at] + args[at + n:]
        if name in BOXED and name not in self.row0 and BOXED[name][1] == 4:
            at = BOXED[name][0] + 3
            return args[:at] + args[at + 1:]
        return args


def stream():
    return torch.cuda.current_stream().cuda_stream


def spmv_call(lib, diag, cols, offsets, x):
    """lib's shift_spmv on contiguous split planes (the wrapper's call)."""
    from orc_tpu_torch.ops import _cuda

    y = torch.empty_like(x)
    ptrs, strides, offs = _cuda.column_args(cols, offsets)
    B = 1 if x.ndim == 1 else x.shape[0]
    code = _cuda.dtype_code(x)

    def run():
        err = lib.orc_shift_spmv(code, diag.data_ptr(), ptrs, strides, offs,
                                 len(cols), x.data_ptr(), y.data_ptr(),
                                 x.shape[-1], B, stream())
        if err:
            raise RuntimeError(f"orc_shift_spmv: CUDA error {err}")
        return y

    return run


def nbr_call(lib, plan, flat, interior):
    """lib's slice_nbr on x [C, F] (the wrapper's call)."""
    from orc_tpu_torch.ops import _cuda

    C, F = flat.shape
    K = plan.col_tile.shape[1]
    out = torch.empty((C, K, F), dtype=flat.dtype, device=flat.device)
    code = _cuda.dtype_code(flat)

    def run():
        err = lib.orc_slice_nbr(code, flat.data_ptr(), interior.data_ptr(),
                                plan.starts.data_ptr(), plan.col_tile.data_ptr(),
                                out.data_ptr(), C, K, F, plan.tile, plan.n_max,
                                plan.pad_lo, stream())
        if err:
            raise RuntimeError(f"orc_slice_nbr: CUDA error {err}")
        return out

    return run


def slice_call(lib, diag, coef, plan, x):
    """lib's slice_spmv (the wrapper's call): diag / coef shared by the
    batch or one per batch row of x."""
    from orc_tpu_torch.ops import _cuda
    from orc_tpu_torch.ops.slice_spmv import _batch_stride

    B = 0 if x.ndim == 1 else x.shape[0]
    d_bs, c_bs = _batch_stride(diag, 1, B, "diag"), _batch_stride(coef, 3, B, "coef")
    y = torch.empty_like(x)
    code = _cuda.dtype_code(x)

    def run():
        err = lib.orc_slice_spmv(code, diag.data_ptr(), d_bs, coef.data_ptr(), c_bs,
                                 plan.starts.data_ptr(), plan.tile_nj.data_ptr(),
                                 x.data_ptr(), y.data_ptr(), plan.n_cells, plan.tile,
                                 plan.ntiles, plan.n_max, plan.pad_lo, max(B, 1),
                                 stream())
        if err:
            raise RuntimeError(f"orc_slice_spmv: CUDA error {err}")
        return y

    return run


def routed(v, launch, *args):
    """`launch(*args)`, a launch helper of fused_assembly, with its
    kernel taken from v's library: both versions take the wrapper's own
    arguments."""
    from orc_tpu_torch.ops import _cuda

    def call(name, device, *cargs):
        err = getattr(v.lib, name)(*v.unboxed(name, cargs), stream())
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def run():
        saved, _cuda.call = _cuda.call, call
        try:
            return launch(*args)
        finally:
            _cuda.call = saved

    return run


def card(fn):
    return cs.card_ms(fn, cs.time_ms(fn, reps=3, inner=5))


_FLUSH = []


def cold(fn, calls=10):
    """Card time per call with the 50 MB L2 emptied before each: a 128 MB
    write, then CUDA events around the one call (queued behind the write,
    so the host's dispatch is not timed)."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(32 * 2**20, dtype=torch.float32, device="cuda"))
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(calls):
        _FLUSH[0].fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def ab(label, base, new, library, nbytes, reps, results, plain=None):
    """Time base/new/new/base `reps` times, back to back (card_ms: the
    inputs stay in L2 where they fit) and with L2 emptied first (cold),
    and after them the library call and the `plain` version where given;
    medians of each."""
    t = {k: [] for k in ("base", "new", "library", "plain", "base_cold", "new_cold",
                         "library_cold", "plain_cold")}
    turns = (("base", base), ("new", new), ("new", new), ("base", base))
    if library is not None:
        turns += (("library", library),)
    if plain is not None:
        turns += (("plain", plain),)
    for _ in range(reps):
        for v, fn in turns:
            t[v].append(card(fn))
            t[f"{v}_cold"].append(cold(fn))
    med = {k: float(np.median(v)) if v else None for k, v in t.items()}
    lib = "none" if library is None else f"{med['library']:.4f} | {med['library_cold']:.4f}"
    if plain is not None:
        lib += f"; plain {med['plain']:.4f} | {med['plain_cold']:.4f}"
    bound = 1e3 * nbytes / cs.HBM_BYTES_PER_S
    share = {k: bound / v for k, v in med.items() if v}
    cs.log(
        f"  {label:32s} bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB); ms (share of "
        f"3.35 TB/s) warm | cold: base {med['base']:.4f} ({100 * share['base']:.1f}%) | "
        f"{med['base_cold']:.4f} ({100 * share['base_cold']:.1f}%); new {med['new']:.4f} "
        f"({100 * share['new']:.1f}%) | {med['new_cold']:.4f} ({100 * share['new_cold']:.1f}%); "
        f"library {lib}"
    )
    results.append(dict(label=label, **{f"{k}_ms": v for k, v in med.items()},
                        runs=t, bound_ms=bound, mbytes=nbytes / 1e6))


def spmv_shapes(dev, libs, reps, results):
    from orc_tpu_torch.ops.shift_spmv import shift_spmv_plain

    f32, f64 = torch.float32, torch.float64
    shapes = (
        ("1024^2 f32 B=1", 1024 * 1024, (-1024, -1, 1, 1024), 1, f32),
        ("1024^2 f32 B=3", 1024 * 1024, (-1024, -1, 1, 1024), 3, f32),
        ("128^3 f32 K=6 B=1", 128**3, (-16384, -128, -1, 1, 128, 16384), 1, f32),
        ("couette 128x64 f64 B=1", 128 * 64, (-128, -1, 1, 128), 1, f64),
        ("couette 128x64 f64 B=3", 128 * 64, (-128, -1, 1, 128), 3, f64),
        ("1023x1025 f32 B=1 (odd C)", 1023 * 1025, (-1023, -1, 1, 1023), 1, f32),
    )
    for label, C, offsets, B, dt in shapes:
        diag, off, x = cs.structured_system(C, offsets, B, dt, dev)
        planes = off.T.contiguous()
        cols = tuple(planes)
        base, new = (spmv_call(v.lib, diag, cols, offsets, x) for v in libs)
        ref = shift_spmv_plain(diag, cols, offsets, x)
        yb, yn = base().clone(), new().clone()
        torch.cuda.synchronize()
        _, rel = cs.max_err(yn, ref)
        if not rel[0] <= cs.TOL[dt]:
            raise AssertionError(f"spmv {label}: new kernel off by {rel[0]:.2e} of scale")
        cs.log(f"  spmv {label}: new vs plain {rel[0]:.2e} of scale; new == base bitwise: {torch.equal(yn, yb)}")
        sz = dt.itemsize
        ab(f"spmv {label}", base, new, cs.shift_csr_call(diag, cols, offsets, x),
           C * ((1 + len(offsets)) * sz + 2 * B * sz), reps, results)
        del diag, off, x, planes, cols


def gather_shapes(dev, libs, reps, results):
    from orc_tpu_torch.ops.slice_spmv import slice_nbr_values_plain

    cases = (
        ("448^2 f32", lambda: cs.permuted_cavity(448, torch.float32, dev)[0]),
        ("448^2 f64", lambda: cs.permuted_cavity(448, torch.float64, dev)[0]),
        ("1024^2 f32", lambda: cs.permuted_cavity(1024, torch.float32, dev)[0]),
        ("couette 128x64 f64", lambda: cs.permuted_mesh(
            cs.couette_mesh("cpu")[0], torch.float64, dev)[0]),
    )
    rng = np.random.default_rng(0)
    for label, make in cases:
        t0 = time.perf_counter()
        mesh = make()
        dt = mesh.dtype
        plan = mesh.slice_plan
        cs.log(f"  {label}: {cs.plan_line(mesh)}; built in {time.perf_counter() - t0:.1f} s")
        interior = cs._interior(mesh).contiguous()
        nbr = mesh.cell_neighbors.long()
        C, K = interior.shape
        n_int = int(interior.sum())
        for F in (1, 3, 9):
            flat = torch.tensor(rng.standard_normal((C, F)), dtype=dt, device=dev)
            base, new = (nbr_call(v.lib, plan, flat, interior) for v in libs)
            ref = slice_nbr_values_plain(plan, flat, interior)
            ok = torch.equal(new(), ref) and torch.equal(new(), flat[nbr])
            if not (ok and torch.equal(base(), ref)):
                raise AssertionError(f"gather {label} F={F}: not bitwise equal")
            sz = dt.itemsize
            ab(f"gather {label} F={F}", base, new, lambda: flat[nbr],
               C * K + 4 * n_int + C * F * sz + C * K * F * sz, reps, results)
        del mesh, interior, nbr


def _bitwise(got, other):
    got, other = (t if isinstance(t, tuple) else (t,) for t in (got, other))
    return all(torch.equal(a, b) for a, b in zip(got, other))


def _check(label, base, new, plain, dtype, outputs):
    """New against the plain version at chip_smoke's tolerance (each
    output at its own scale); returns whether new equals base bitwise."""
    yb, yn, ref = base(), new(), plain()
    torch.cuda.synchronize()
    _, rels = cs.max_err(yn, ref)
    per = " ".join(f"{o}={r:.2e}" for o, r in zip(outputs, rels))
    if not all(r <= cs.TOL[dtype] for r in rels):
        raise AssertionError(f"{label}: new kernel off its plain version ({per})")
    same = _bitwise(yn, yb)
    cs.log(f"  {label}: new vs plain {per} of scale; new == base bitwise: {same}")
    return same


def slice_shapes(dev, libs, reps, results):
    """Row 7 on the four meshes of chip_smoke's phase_slice_kernels at
    B = 1 and 3, and on scripts/bench_df32_ir.py's 1024-row plan in the
    four forms phase 12 (a) runs it."""
    from orc_tpu_torch.ops.df32 import df_from_f64
    from orc_tpu_torch.ops.slice_spmv import slice_spmv_plain
    from orc_tpu_torch.ops.spmv import EllMatrix

    cases = (
        ("448^2 f32", lambda: cs.permuted_cavity(448, torch.float32, dev)[0]),
        ("448^2 f64", lambda: cs.permuted_cavity(448, torch.float64, dev)[0]),
        ("1024^2 f32", lambda: cs.permuted_cavity(1024, torch.float32, dev)[0]),
        ("couette 128x64 f64", lambda: cs.permuted_mesh(
            cs.couette_mesh("cpu")[0], torch.float64, dev)[0]),
    )
    for label, make in cases:
        mesh = make()
        dt, plan, C = mesh.dtype, mesh.slice_plan, mesh.n_cells
        interior = cs._interior(mesh)
        K = interior.shape[1]
        rng = np.random.default_rng(0)
        off = -torch.tensor(rng.uniform(0.0, 1.0, (C, K)), dtype=dt, device=dev) * interior
        diag = 1.0 + off.abs().sum(dim=1) + torch.tensor(rng.random(C), dtype=dt, device=dev)
        A, _ = EllMatrix(diag, off, mesh.cell_neighbors, plan=plan).prepare().jacobi_preconditioned()
        used, sz = cs._used_coefs(plan), dt.itemsize
        for B in (1, 3):
            x = torch.tensor(rng.standard_normal((B, C) if B > 1 else C), dtype=dt, device=dev)
            base, new = (slice_call(v.lib, A.diag, A.off, plan, x) for v in libs)
            name = f"slice {label} B={B}"
            same = _check(name, base, new, lambda: slice_spmv_plain(A.diag, A.off, plan, x),
                          dt, ("y",))
            ab(name, base, new, cs.plan_csr_call(A.diag, A.off, plan, x),
               used * sz + C * sz + 2 * B * C * sz + plan.ntiles * 4 * (1 + plan.n_max),
               reps, results)
            results[-1]["bitwise"] = same
        del A, off, diag, mesh
    (m64, _), x_true = cs._bench_df32_system(dev)
    A = m64[0].prepare()
    plan, C = A.plan, A.plan.n_cells
    used = cs._used_coefs(plan)
    P64, _ = A.jacobi_preconditioned()
    hi, lo = df_from_f64(A.off)
    x64 = torch.tensor(x_true, device=dev)
    xh, xl = df_from_f64(x64)
    P32, _ = EllMatrix(
        df_from_f64(A.diag)[0], hi, A.neighbors, plan=plan, slice_layout=True
    ).jacobi_preconditioned()
    zero = torch.zeros(C, dtype=torch.float32, device=dev)
    for form, d, c, x in (
        ("f32 inner solve", P32.diag, P32.off, xh),
        ("f32 hi*lo cross term", zero, hi, xl),
        ("f32 lo*hi cross term", zero, lo, xh),
        ("f64 native solve", P64.diag, P64.off, x64),
    ):
        sz = x.dtype.itemsize
        base, new = (slice_call(v.lib, d, c, plan, x) for v in libs)
        name = f"slice 1024-row plan {form}"
        same = _check(name, base, new, lambda: slice_spmv_plain(d, c, plan, x), x.dtype, ("y",))
        ab(name, base, new, cs.plan_csr_call(d, c, plan, x),
           used * sz + 3 * C * sz + plan.ntiles * 4 * (1 + plan.n_max), reps, results)
        results[-1]["bitwise"] = same
    del A, P64, P32, hi, lo


def per_row_planes(C, offsets, B, dtype, dev):
    """A seeded system per batch row in the solver's per-component
    layout: diag [B,C] and K [B,C] columns over [B,K,C] storage."""
    rows = [cs.structured_system(C, offsets, 1, dtype, dev, seed=r) for r in range(B)]
    diag = torch.stack([d for d, _o, _x in rows])
    off = torch.stack([o.T for _d, o, _x in rows]).contiguous()
    return diag, tuple(off[:, k, :] for k in range(len(offsets)))


def march_variants(fs, dims, dtype):
    """Marches beside the picked one: depths 1-3 in march_shape's
    windows, and 32 x 32 windows over 16-plane chunks at depths 2 and 3
    (two waves of CTAs)."""
    return tuple(
        fs.SweepPlan(S, dims, fs.march_shape(dims, S, dtype), march=True)
        for S in range(1, fs.MAX_DEPTH_MARCH + 1)
    ) + tuple(
        fs.SweepPlan(S, dims, (32 - 2 * S, 32 - 2 * S, 16), march=True) for S in (2, 3)
    )


def _base_plan(base, plan, fs):
    """The plan the base version runs beside `plan`: the same where it
    has that instance, else its launch per sweep (a base without the
    tiles' box arguments, without the per-row tiles or without the
    march)."""
    entry = "orc_jacobi_sweeps_rows" if plan.per_row else "orc_jacobi_sweeps"
    if (plan.march and not base.march) or (plan.depth and entry not in base.boxed):
        return fs.SweepPlan(per_row=plan.per_row)
    return plan


def sweeps_shapes(dev, libs, reps, results):
    """Row 2, six sweeps, at chip_smoke's shapes: the 1024^2 f32 cavity's
    system at B = 3 and 1, the 128^3 f32 K = 6 system at B = 3, the
    128x64 f64 couette's at B = 3, and one matrix per batch row (B = 3) on
    the 1024^2 f32 and the f64 couette's shapes, each in the instance
    sweep_plan picks and in the variants beside it (S sweeps a tiled or
    marching launch, the march's windows, the launch per sweep), against
    the base's instance (its
    launch per sweep where it lacks the variant's); bytes: diag, K
    columns (per batch row when one matrix each), b and x0 read once, x
    written once."""
    from orc_tpu_torch.ops import fused_smooth as fs

    spec = importlib.util.spec_from_file_location(
        "torch_kernel_refs", ROOT / "tests" / "torch_kernel_refs.py")
    refs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(refs)
    jacobi_fma_chain = refs.jacobi_fma_chain
    f32, f64 = torch.float32, torch.float64
    cube = (128, 128, 128)
    cases = (
        ("1024^2 f32 B=3", (1024, 1024, 1), 3, f32, False, (None, 2, 3)),
        ("1024^2 f32 B=1", (1024, 1024, 1), 1, f32, False, (None,)),
        ("128^3 f32 K=6 B=3", cube, 3, f32, False,
         (None, 0, 1, 2) + march_variants(fs, cube, f32)),
        ("couette 128x64 f64 B=3", (128, 64, 1), 3, f64, False, (None,)),
        ("per-row 1024^2 f32 B=3", (1024, 1024, 1), 3, f32, True, (None, 0, 2, 3)),
        ("per-row couette 128x64 f64 B=3", (128, 64, 1), 3, f64, True, (None, 0)),
    )
    for label, (nx, ny, nz), B, dt, per_row, variants in cases:
        if MATCH not in label:
            continue
        C = nx * ny * nz
        offsets = tuple(d for d in (-nx * ny, -nx, -1, 1, nx, nx * ny) if abs(d) < C)
        if per_row:
            diag, cols = per_row_planes(C, offsets, B, dt, dev)
            x0 = cs.structured_system(C, offsets, B, dt, dev, seed=7)[2]
            nbytes = B * C * (1 + len(cols) + 3) * dt.itemsize
        else:
            diag, off, x0 = cs.structured_system(C, offsets, B, dt, dev)
            cols = tuple(off.T.contiguous())
            nbytes = C * (1 + len(cols) + 3 * B) * dt.itemsize
        b = cs.structured_system(C, offsets, B, dt, dev, seed=1)[2]
        for v in variants:
            plan = v if isinstance(v, fs.SweepPlan) else fs.sweep_plan(
                offsets, C, 6, dt, depth=v, per_row=per_row)
            base = routed(libs[0], fs._launch_sweeps, diag, cols, offsets, b, x0, 6, 0.8,
                          _base_plan(libs[0], plan, fs))
            new = routed(libs[1], fs._launch_sweeps, diag, cols, offsets, b, x0, 6, 0.8,
                         plan)
            name = f"sweeps {label} {plan.label()}{' (picked)' if v is None else ''}"
            same = _check(name, base, new,
                          lambda: fs.sweeps_plain(diag, cols, offsets, b, x0, 6, 0.8),
                          dt, ("x",))
            if dt == f32:  # values off the rounding the kernels spell out
                chain = jacobi_fma_chain(diag, cols, offsets, b, x0, 6, 0.8)
                off = [int((fn() != chain).sum()) for fn in (base, new)]
                cs.log(f"  {name}: values off the f64-emulated FMA chain: base {off[0]}, "
                       f"new {off[1]} of {x0.numel()}")
            ab(name, base, new, None, nbytes, reps, results)
            results[-1].update(bitwise=same, launches=plan.launches(6, B))
        del diag, x0, b, cols


def exact_shapes(dev, libs, reps, results):
    """Row 12 at chip_smoke's shapes: the f32 hi planes of the permuted
    448^2 cavity's prepared f64 system at B = 1 and 3, and of
    scripts/bench_df32_ir.py's system (1024-row tiles), bitwise against
    the plain version (and reported against the base)."""
    from orc_tpu_torch.ops import slice_spmv as ss
    from orc_tpu_torch.ops.df32 import df_from_f64
    from orc_tpu_torch.ops.spmv import EllMatrix

    mesh = cs.permuted_cavity(448, torch.float64, dev)[0]
    plan, C = mesh.slice_plan, mesh.n_cells
    interior = cs._interior(mesh)
    rng = np.random.default_rng(0)
    off = -torch.tensor(rng.uniform(0.0, 1.0, (C, interior.shape[1])), device=dev) * interior
    diag = 1.0 + off.abs().sum(dim=1)
    coef = df_from_f64(EllMatrix(diag, off, mesh.cell_neighbors, plan=plan).prepare().off)[0]
    cases = [("448^2", coef, plan, B,
              df_from_f64(torch.tensor(rng.standard_normal((B, C) if B > 1 else C),
                                       device=dev))[0]) for B in (1, 3)]
    (m64, _), x_true = cs._bench_df32_system(dev)
    A = m64[0].prepare()
    cases.append(("1024-row plan", df_from_f64(A.off)[0], A.plan, 1,
                  df_from_f64(torch.tensor(x_true, device=dev))[0]))
    for label, coef, plan, B, x in cases:
        C, used = plan.n_cells, cs._used_coefs(plan)
        base, new = (routed(v, ss._launch_slice_spmv_exact, coef, 0, plan, x, B)
                     for v in libs)
        name = f"exact {label} B={B}"
        yn, ref = new(), ss.slice_spmv_exact_plain(coef, plan, x)
        if not _bitwise(yn, ref):
            raise AssertionError(f"{name}: new kernel not bitwise equal to its plain version")
        same = _bitwise(yn, base())
        cs.log(f"  {name}: new == plain bitwise: True; new == base bitwise: {same}")
        ab(name, base, new, None,
           used * 4 + 3 * B * C * 4 + plan.ntiles * 4 * (1 + plan.n_max), reps, results)
        results[-1]["bitwise"] = same
    del mesh, off, diag, A, cases


def momentum_shapes(dev, libs, reps, results):
    """Row 3 at chip_smoke's instances on the 1024^2 f32 cavity (five
    steady, two transient), on the 128x64 f64 couette and on the 128^3
    f32 cavity (UD, K = 6), and row 5 in its three instances on each,
    from seeded fields."""
    from orc_tpu_torch.models.cavity import cavity_case
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.ops.ck_ops import (
        build_ck_geometry,
        ck_bc,
        ck_pressure_gradient,
        ck_velocity_gradient,
    )
    from orc_tpu_torch.ops.fields import device_bc
    from orc_tpu_torch.utils.settings import tvd_umist

    cd1 = asm.AsmSpec(scheme="cd1", rc=True, p_so=True, gg=True)
    steady = (
        ("ud", asm.AsmSpec()),
        ("cd1+so+rc gg", cd1),
        ("tvd_dc+umist+rc gg", cd1._replace(scheme="tvd_dc", psi=tvd_umist, p_so=False)),
        ("cd1+so+rc streamed grad p", cd1._replace(gg=False)),
        ("cd1+so gg", cd1._replace(rc=False)),
    )
    cases = (
        ("1024^2 f32", lambda: cavity_case(n=1024, dtype=torch.float32, device=dev),
         steady, ("ud", "cd1+so+rc gg")),
        ("couette 128x64 f64", lambda: cs.couette_mesh(dev), steady[:2], ()),
        ("128^3 f32 K=6", lambda: cavity_case(n=128, nz=128, dtype=torch.float32, device=dev),
         steady[:1], ()),
    )
    for label, make, specs, transient in cases:
        mesh, table = make()
        dt, C = mesh.dtype, mesh.n_cells
        zc, zs, zv = device_bc(table, dtype=dt, device=dev)
        ck = build_ck_geometry(mesh, len(table.zone_ids))
        bc = ck_bc(ck, zc, zs, zv)
        cols = asm.column_specs(mesh, table)
        flags, bcv = asm.pack_flags(ck.interior, ck.mask), asm.bc_value_table(zs, zv)
        rng = np.random.default_rng(3)
        vel = torch.tensor(rng.standard_normal((C, 3)) * 0.1, dtype=dt, device=dev)
        p = torch.tensor(rng.standard_normal(C) * 0.05, dtype=dt, device=dev)
        md = torch.tensor(rng.uniform(0.5, 2.0, C), dtype=dt, device=dev)
        grad_p = ck_pressure_gradient(mesh, ck, bc, p)
        grad_v = ck_velocity_gradient(mesh, ck, bc, vel)
        inertia = cs.step_inertia(mesh, vel, 1.0, 1.0 / 1024)
        vol = float(mesh.cell_volume[0])
        margs = (vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7)
        K, sz = len(cols), dt.itemsize
        runs = [(n, sp, False) for n, sp in specs]
        runs += [(n, sp, True) for n, sp in specs if n in transient]
        for name, sp, tr in runs:
            sp = sp._replace(vol=vol)
            tvd, streamed = sp.scheme == "tvd_dc", (sp.rc or sp.p_so) and not sp.gg
            kw = dict(grad_p=grad_p if streamed else None, mom_diag=md if sp.rc else None,
                      grad_vel=grad_v if tvd else None,
                      inertia=inertia if tr else None, spec=sp)
            base, new = (routed(v, asm._launch_momentum, *margs, *kw.values())
                         for v in libs)
            tag = f"momentum {label} {name}{' transient' if tr else ''}"
            same = _check(tag, base, new, lambda: asm.momentum_assembly_plain(*margs, **kw),
                          dt, cs.ASM_OUT)
            # vel, p (+ md, a streamed grad p, grad vel, rho V/dt and
            # vel^n); diag, K off planes, 3 b rows; the flag word.
            reads = 4 + sp.rc + 3 * streamed + 9 * tvd + cs.INERTIA_READS * tr
            ab(tag, base, new, None, C * (4 + (reads + 1 + K + 3) * sz), reps, results)
            results[-1]["bitwise"] = same
        # Row 5 in its three instances.
        for name, sp in (("linear", asm.AsmSpec()), ("rc gg", cd1),
                         ("rc streamed", cd1._replace(gg=False))):
            sp = sp._replace(vol=vol)
            streamed = sp.rc and not sp.gg
            pargs = (vel, md, bcv, flags, cols, 1.0, p if sp.rc else None,
                     grad_p if streamed else None, sp)
            base, new = (routed(v, asm._launch_pc, *pargs) for v in libs)
            tag = f"pc {label} {name}"
            same = _check(tag, base, new,
                          lambda: asm.pc_assembly_plain(*pargs[:-1], spec=sp), dt, cs.ASM_OUT)
            # vel, md (+ p and a streamed grad p); diag, K off, b; the flag word.
            reads = 4 + sp.rc + 3 * streamed
            ab(tag, base, new, None, C * (4 + (reads + 1 + K + 1) * sz), reps, results)
            results[-1]["bitwise"] = same
        del mesh, ck, vel, p, md, grad_p, grad_v, inertia


def fc_shapes(dev, libs, reps, results):
    """Rows 4 and 6 on chip_smoke's two SIMPLE_FC cases (phase 3), the
    1024^2 f32 cavity with the flagship numerics (TVD_DC + UMIST + RC)
    and the 128x64 f64 couette (CD1 + SecondOrder + RC), and in their UD,
    Linear instances on the 1024^2 cavity, row 4 steady and transient,
    from seeded fields and a seeded stored flux; row 6 (the predictor
    under each case's face flux, its plain version timed beside it) also
    on the 128^3 f32 K = 6 cavity with Rhie-Chow."""
    from orc_tpu_torch.models.cavity import cavity_case
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.ops.ck_ops import (
        build_ck_geometry,
        ck_bc,
        ck_pressure_gradient,
        ck_velocity_gradient,
    )
    from orc_tpu_torch.ops.fields import device_bc
    from orc_tpu_torch.utils.settings import tvd_umist

    cases = (
        ("1024^2 f32 tvd_dc+umist+rc",
         lambda: cavity_case(n=1024, dtype=torch.float32, device=dev),
         asm.AsmSpec(scheme="tvd_dc", psi=tvd_umist, rc=True), 1.0, 1e-3, 1.0 / 1024),
        ("1024^2 f32 ud", lambda: cavity_case(n=1024, dtype=torch.float32, device=dev),
         asm.AsmSpec(), 1.0, 1e-3, 1.0 / 1024),
        ("couette 128x64 f64 cd1+so+rc", lambda: cs.couette_mesh(dev),
         asm.AsmSpec(scheme="cd1", rc=True, p_so=True), 1000.0, 1e-3, 0.005),
        ("128^3 f32 K=6 rc",
         lambda: cavity_case(n=128, nz=128, dtype=torch.float32, device=dev),
         asm.AsmSpec(rc=True), 1.0, 1e-3, None),
    )
    for label, make, sp, rho, mu, dt_step in cases:
        mesh, table = make()
        dt, C = mesh.dtype, mesh.n_cells
        zc, zs, zv = device_bc(table, dtype=dt, device=dev)
        ck = build_ck_geometry(mesh, len(table.zone_ids))
        bc = ck_bc(ck, zc, zs, zv)
        cols = asm.column_specs(mesh, table)
        flags, bcv = asm.pack_flags(ck.interior, ck.mask), asm.bc_value_table(zs, zv)
        K, sz = len(cols), dt.itemsize
        rng = np.random.default_rng(5)
        vel = torch.tensor(rng.standard_normal((C, 3)) * 0.1, dtype=dt, device=dev)
        p = torch.tensor(rng.standard_normal(C) * 0.05, dtype=dt, device=dev)
        md = torch.tensor(rng.uniform(0.5, 2.0, C), dtype=dt, device=dev)
        flux = torch.tensor(rng.standard_normal((K, C)) * 0.1, dtype=dt, device=dev).T
        grad_p = ck_pressure_gradient(mesh, ck, bc, p)
        grad_v = ck_velocity_gradient(mesh, ck, bc, vel)
        sp = sp._replace(vol=float(mesh.cell_volume[0]))
        margs = (vel, p, flux, bcv, flags, cols, rho, mu, 0.7)
        tvd = sp.scheme == "tvd_dc"
        # Row 4 on the 2-D cases only.
        for tr in (False, True) if dt_step is not None else ():
            kw = dict(grad_p=grad_p if sp.p_so else None, grad_vel=grad_v if tvd else None,
                      inertia=cs.step_inertia(mesh, vel, rho, dt_step) if tr else None,
                      spec=sp)
            base, new = (routed(v, asm._launch_fc_momentum, *margs, *kw.values())
                         for v in libs)
            tag = f"fc momentum {label}{' transient' if tr else ''}"
            same = _check(tag, base, new,
                          lambda: asm.fc_momentum_assembly_plain(*margs, **kw), dt, cs.ASM_OUT)
            # vel, p, K flux planes (+ grad vel, grad p, rho V/dt and
            # vel^n); diag, K off, 3 b; the flag word.
            reads = 4 + K + 9 * tvd + 3 * sp.p_so + cs.INERTIA_READS * tr
            ab(tag, base, new, None, C * (4 + (reads + 1 + K + 3) * sz), reps, results)
            results[-1]["bitwise"] = same
        pargs = (vel, md, bcv, flags, cols, rho, grad_p, sp)
        base, new = (routed(v, asm._launch_fc_pc, *pargs) for v in libs)
        tag = f"fc pc {label}"
        plain = functools.partial(asm.fc_pc_assembly_plain, *pargs)
        same = _check(tag, base, new, plain, dt, cs.ASM_OUT + ("flux_h",))
        # vel, md (+ grad p); diag, K off, b, K flux_h; the flag word
        # (chip_smoke phase 3).
        ab(tag, base, new, None, C * (4 + (4 + 3 * sp.rc + 2 + 2 * K) * sz), reps,
           results, plain=plain)
        results[-1]["bitwise"] = same
        del mesh, ck, vel, p, md, flux, grad_p, grad_v


def fm_shapes(dev, libs, reps, results):
    """The face-major momentum kernel (csrc/fm_assembly.cu) of the new
    version against the plain face_pressure + momentum_system it
    replaces, in turns (kernel, plain, plain, kernel), at the 1024^2 f32
    cavity with the flagship numerics (TVD_DC + UMIST, LINEAR_WEIGHTED
    face pressures, implicit relaxation) and the 128^3 f32 K = 6 cavity
    with the cube's (UD, LINEAR_WEIGHTED), from seeded fields, a seeded
    [F] flux and the Green-Gauss velocity gradient; two launches give
    the same bits. The base version has no such kernel."""
    from orc_tpu_torch.models.cavity import cavity_case, flagship_settings
    from orc_tpu_torch.ops import fm_assembly as fm
    from orc_tpu_torch.ops.assembly import diffusion_system
    from orc_tpu_torch.ops.fields import device_bc, face_bc
    from orc_tpu_torch.ops.gradients import velocity_gradient
    from orc_tpu_torch.utils.settings import (
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        RelaxationMode,
    )

    new = libs[1]
    cube = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        relaxation_mode=RelaxationMode.IMPLICIT, momentum_relaxation=0.7,
    )
    cases = (
        ("1024^2 f32 tvd_dc+umist", lambda: cavity_case(n=1024, dtype=torch.float32, device=dev),
         flagship_settings()),
        ("128^3 f32 K=6 ud", lambda: cavity_case(n=128, nz=128, dtype=torch.float32, device=dev),
         cube),
    )
    for label, make, settings in cases:
        mesh, table = make()
        dt, C = mesh.dtype, mesh.n_cells
        zc, zs, zv = device_bc(table, dtype=dt, device=dev)
        fbc = face_bc(mesh, zc, zs, zv)
        diff = diffusion_system(mesh, fbc, torch.tensor(1e-3, dtype=dt, device=dev))
        rng = np.random.default_rng(5)
        vel = torch.tensor(rng.standard_normal((C, 3)) * 0.1, dtype=dt, device=dev)
        p = torch.tensor(rng.standard_normal(C) * 0.05, dtype=dt, device=dev)
        flux = torch.tensor(rng.standard_normal(mesh.n_faces) * 0.1, dtype=dt, device=dev)
        grad_v = velocity_gradient(mesh, fbc, vel, settings.gradient_reconstruction)
        args = (mesh, fbc, settings, 1.0, vel, flux, p, diff)
        kernel = routed(new, fm.fm_momentum_assembly, *args, grad_v)
        plain = functools.partial(fm.fm_momentum_plain, *args, grad_vel=grad_v)

        def outs(r):
            A, b, pe = r
            return (A.diag, A.off, b, pe)

        first, second, ref = outs(kernel()), outs(kernel()), outs(plain())
        torch.cuda.synchronize()
        _, rels = cs.max_err(first, ref)
        per = " ".join(f"{o}={r:.2e}" for o, r in zip(("diag", "off", "b", "pe"), rels))
        if not all(r <= cs.TOL[dt] for r in rels):
            raise AssertionError(f"fm momentum {label}: kernel off its plain version ({per})")
        same = _bitwise(first, second)
        cs.log(f"  fm momentum {label}: kernel vs plain {per} of scale; two launches "
               f"bitwise equal: {same}")
        nbytes = cs.fm_bytes(mesh, settings)
        t = {k: [] for k in ("kernel", "plain", "kernel_cold", "plain_cold")}
        for _ in range(reps):
            for v, fn in (("kernel", kernel), ("plain", plain), ("plain", plain),
                          ("kernel", kernel)):
                t[v].append(card(fn))
                t[f"{v}_cold"].append(cold(fn))
        med = {k: float(np.median(v)) for k, v in t.items()}
        bound = 1e3 * nbytes / cs.HBM_BYTES_PER_S
        cs.log(
            f"  fm momentum {label:26s} bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB); ms "
            f"(share of 3.35 TB/s) warm | cold: kernel {med['kernel']:.4f} "
            f"({100 * bound / med['kernel']:.1f}%) | {med['kernel_cold']:.4f} "
            f"({100 * bound / med['kernel_cold']:.1f}%); plain {med['plain']:.4f} | "
            f"{med['plain_cold']:.4f}"
        )
        results.append(dict(label=f"fm momentum {label}",
                            **{f"{k}_ms": v for k, v in med.items()}, runs=t,
                            bound_ms=bound, mbytes=nbytes / 1e6, bitwise_repeat=same))
        del mesh, fbc, diff, vel, p, flux, grad_v


#: Only the sweeps shapes whose label holds this text (--match).
MATCH = ""

GROUPS = dict(sweeps=sweeps_shapes, exact=exact_shapes, momentum=momentum_shapes,
              fc=fc_shapes, slice=slice_shapes, spmv=spmv_shapes, gather=gather_shapes,
              fm=fm_shapes)


def sass_counts(lib: Path):
    """(kernel, SASS instruction count) of each kernel of REPORTED in
    `lib`, from cuobjdump, names demangled where c++filt exists."""
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, name, n = [], None, 0
    for line in text.splitlines() + ["Function : end"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name and any(k in name for k in REPORTED):
                out.append((name, n))
            name, n = cs.demangle(m.group(1)), 0
        elif re.search(r"/\*[0-9a-f]{4,}\*/", line):
            n += 1
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="csrc directory of the base version")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help=f"comma-separated groups to run, of {', '.join(GROUPS)}")
    ap.add_argument("--sass", action="store_true",
                    help="also print the SASS instruction count of each kernel "
                         "of REPORTED (cuobjdump)")
    ap.add_argument("--match", default="",
                    help="time only the sweeps shapes whose label holds this text "
                         "(e.g. 128^3)")
    args = ap.parse_args()
    global MATCH
    MATCH = args.match
    only = args.only.split(",")
    if not set(only) <= set(GROUPS):
        raise SystemExit(f"--only takes groups of {GROUPS}, got {only}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    cs.log(smi)
    out = ROOT / "build" / "kernel_ab"
    out.mkdir(parents=True, exist_ok=True)
    paths = (out / "libbase.so", out / "libnew.so")
    dirs = (args.base.resolve(), ROOT / "orc_tpu_torch" / "csrc")
    plans = [build(d, p) for d, p in zip(dirs, paths)]
    t0 = time.perf_counter()
    procs = [[subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for c in compiles] for compiles, _link in plans]
    for tag, (compiles, link), ps in zip(("base", "new"), plans, procs):
        for c, p in zip(compiles, ps):
            o, e = p.communicate()
            if p.returncode:
                raise SystemExit(f"nvcc failed:\n{' '.join(c)}\n{e}{o}")
            for name, regs, spills in cs.ptxas_report(e):
                if any(k in name for k in REPORTED):
                    cs.log(f"  ptxas {tag} {name}: {regs} registers, spills {spills}")
        done = subprocess.run(link, capture_output=True, text=True)
        if done.returncode:
            raise SystemExit(f"nvcc failed:\n{' '.join(link)}\n{done.stderr}")
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    if args.sass:
        for tag, path in zip(("base", "new"), paths):
            for name, n in sass_counts(path):
                cs.log(f"  sass {tag} {name}: {n} instructions")
    libs = tuple(Version(p, d) for p, d in zip(paths, dirs))
    results = []
    for group in only:
        GROUPS[group](dev, libs, args.reps, results)
    bad = [r["label"] for r in results if r.get("bitwise") is False]
    cs.log(f"new != base bitwise at: {bad or 'no shape'}")
    dest = ROOT / "chiprun_out" / "kernel_ab.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(dict(device=smi, results=results), indent=1))
    cs.log(f"wrote {dest}")


if __name__ == "__main__":
    main()
