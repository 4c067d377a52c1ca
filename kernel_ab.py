"""Time the structured stencil SpMV and the neighbour gather of two
versions of their CUDA sources in one process on one GPU.

Usage (from the repository root, on a machine with a CUDA GPU):

    git archive <commit> orc_tpu_torch/csrc | tar -x -C build/ab_base
    python3 kernel_ab.py build/ab_base/orc_tpu_torch/csrc [--reps 3]

It builds ``shift_spmv.cu`` and ``slice_spmv.cu`` of the base directory
and of ``orc_tpu_torch/csrc`` into two libraries (nvcc, sm_90a, in
parallel) and, at the shapes chip_smoke.py times, checks that both agree
with the plain torch versions (the gather bitwise) and with each other,
then times each on the card alone (calls queued behind a sleeping
kernel, chip_smoke.card_ms) in the order base, new, new, base, `--reps`
times, with the one PyTorch call computing the same function beside
them. Prints one line per shape and writes every time to
chiprun_out/kernel_ab.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SOURCES = ("shift_spmv.cu", "slice_spmv.cu")


def build(csrc: Path, out: Path):
    """nvcc command building SOURCES of `csrc` into library `out`."""
    from orc_tpu_torch.ops import _cuda

    nvcc = "/usr/local/cuda/bin/nvcc"
    return [nvcc, *_cuda.NVCC_FLAGS, "-Xptxas=-v", "-shared", f"-I{csrc}",
            "-o", str(out), *(str(csrc / s) for s in SOURCES)]


def load(path: Path):
    from orc_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(path))
    for name in ("orc_shift_spmv", "orc_slice_nbr"):
        fn = getattr(lib, name)
        fn.argtypes = _cuda.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


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


def ab(label, base, new, library, nbytes, reps, results):
    """Time base/new/new/base `reps` times, back to back (card_ms: the
    inputs stay in L2 where they fit) and with L2 emptied first (cold);
    medians of each."""
    t = {k: [] for k in ("base", "new", "library", "base_cold", "new_cold", "library_cold")}
    for _ in range(reps):
        for v, fn in (("base", base), ("new", new), ("new", new), ("base", base),
                      ("library", library)):
            t[v].append(card(fn))
            t[f"{v}_cold"].append(cold(fn))
    med = {k: float(np.median(v)) for k, v in t.items()}
    bound = 1e3 * nbytes / cs.HBM_BYTES_PER_S
    share = {k: bound / v for k, v in med.items()}
    cs.log(
        f"  {label:32s} bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB); ms (share of "
        f"3.35 TB/s) warm | cold: base {med['base']:.4f} ({100 * share['base']:.1f}%) | "
        f"{med['base_cold']:.4f} ({100 * share['base_cold']:.1f}%); new {med['new']:.4f} "
        f"({100 * share['new']:.1f}%) | {med['new_cold']:.4f} ({100 * share['new_cold']:.1f}%); "
        f"library {med['library']:.4f} | {med['library_cold']:.4f}"
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
        base, new = (spmv_call(lib, diag, cols, offsets, x) for lib in libs)
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
            base, new = (nbr_call(lib, plan, flat, interior) for lib in libs)
            ref = slice_nbr_values_plain(plan, flat, interior)
            ok = torch.equal(new(), ref) and torch.equal(new(), flat[nbr])
            if not (ok and torch.equal(base(), ref)):
                raise AssertionError(f"gather {label} F={F}: not bitwise equal")
            sz = dt.itemsize
            ab(f"gather {label} F={F}", base, new, lambda: flat[nbr],
               C * K + 4 * n_int + C * F * sz + C * K * F * sz, reps, results)
        del mesh, interior, nbr


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="csrc directory of the base version")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
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
    cmds = (build(args.base.resolve(), paths[0]),
            build(ROOT / "orc_tpu_torch" / "csrc", paths[1]))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    for tag, c, p in zip(("base", "new"), cmds, procs):
        o, e = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed:\n{' '.join(c)}\n{e}{o}")
        for name, regs, spills in cs.ptxas_report(e):
            cs.log(f"  ptxas {tag} {name}: {regs} registers, spills {spills}")
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    libs = tuple(load(p) for p in paths)
    results = []
    spmv_shapes(dev, libs, args.reps, results)
    gather_shapes(dev, libs, args.reps, results)
    dest = ROOT / "chiprun_out" / "kernel_ab.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(dict(device=smi, results=results), indent=1))
    cs.log(f"wrote {dest}")


if __name__ == "__main__":
    main()
