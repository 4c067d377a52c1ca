"""CPU rehearsal of nine Hopper kernels of orc_tpu_torch: the slice-plan
SpMV and its exact product (csrc/slice_spmv.cu, kernel rows 7-9 and
12), the shift SpMV's and the Jacobi sweeps' per-row instances
(csrc/shift_spmv.cu, row 1; csrc/jacobi_sweeps.cu, row 2, also tiled), the parity
momentum assembly (csrc/parity_assembly.cuh, row 3), the SIMPLE_FC
momentum assembly (csrc/assembly.cu, row 4), the pressure-correction
assembly (csrc/parity_assembly.cuh, row 5), the SIMPLE_FC pressure
assembly (csrc/assembly.cu, row 6) and the face-major momentum assembly
(csrc/fm_assembly.cu, row 13), compiled as C++ with g++
against a mock cuda_runtime.h and run through the wrappers' launch
helpers on CPU tensors.

The mock runs a launch's blocks in turn and each block's threads as
std::threads meeting at one std::barrier for __syncthreads() (a thread
that returns leaves it), with `__shared__` as static storage and the
dynamic shared memory as one static buffer; the explicitly rounded
intrinsics are exact (`__fmaf_rn` is std::fmaf), and the sources compile
with -ffp-contract=off, so no multiply-add is contracted that the
source does not spell out. What that checks:

- the slice SpMV, in float32, bitwise against the rounding its source
  spells out (diag * x rounded, then one fused multiply-add per column
  in order, emulated in float64), and in both types against the plain
  version (1e-5 / 1e-12 of the largest value) and orc_tpu's XLA
  `spmv.slice_spmv`: permuted cavities (RCM order, 128-row tiles, a
  ragged last tile), a plan of 1024-row tiles (more rows than a CTA, the
  chunk split), B = 3 and 5 sharing the matrix, B = 3 with one per row;
- the exact slice product, bitwise against its plain version, on the
  same plans and batches;
- the tiled Jacobi sweeps (temporal blocking on box tiles) against the
  plain sweeps (1e-5 / 1e-12 of the largest value) and bitwise against
  the per-sweep kernel (every instance spells out one rounding), on 2-D
  and 3-D boxes with ragged tiles on every side, a box smaller than one
  tile and boxes with an axis of extent 1, fusing 1, 2 or 6 sweeps a
  launch, B = 1 and 3, with coefficients on the faces that cross the
  box's rows (the flat row embedding); a periodic box takes the
  per-sweep kernel;
- the z-march of 3-D boxes (jacobi_march_kernel) the same way, 1, 2 or
  3 sweeps a launch over ragged xy tiles and several z-chunks, B = 1
  and 3;
- the per-row tiles of 2-D boxes (one matrix per batch row) the same
  way at depths 1, 2 and 6, B = 1, 3 and 4, bitwise against the
  per-sweep per-row kernel and, with identical rows, the shared tiles;
- the per-row instances of the shift SpMV and the Jacobi sweeps (one
  matrix per batch row: the CD2 and in-matrix TVD momentum systems) on
  2-D, 3-D and periodic boxes with a ragged C, B = 1, 3 and 4, against
  the plain versions (1e-5 / 1e-12 of the largest value), the shift
  SpMV in float32 bitwise against the rounding its source spells out,
  and each equal bitwise to its shared instance when the rows agree;
- the momentum assembly, in every instance family (scheme x limiter x
  Rhie-Chow x SecondOrder x streamed or in-kernel gradient), steady and
  with the inertia term, against the plain version (1e-5 / 1e-12 of each
  output's largest value), on 10 x 6 and 6 x 5 x 4 channel boxes with a
  velocity inlet and 37 x 9 and 17 x 5 x 3 ones with a pressure inlet,
  each with a pressure outlet: one tile or several, ragged on every
  side;
- the SIMPLE_FC momentum assembly, in every scheme and limiter family,
  with Linear and SecondOrder face pressures, steady and with the
  inertia term, and the pressure-correction assembly in its three
  instances (Linear, Rhie-Chow with the in-kernel or a streamed
  gradient), on the same boxes, against the plain versions (1e-5 /
  1e-12 of each output's largest value);
- the SIMPLE_FC pressure assembly with Linear and Rhie-Chow predictors
  on the same boxes and on every window of a ragged slab partition
  (row0 > 0), each of its four outputs against the plain version;
- the three tiled assembly kernels on every window of a slab partition
  (parallel/partition.py: the global box cut to the planes that hold
  the window's rows, from its first row's place in its plane; ghost,
  padding and trash rows inactive), whole planes or not, in the sharded
  instances (streamed gradient) and the in-kernel gradient ones,
  against the plain versions on every row of the window;
- the face-major momentum assembly against face_pressure +
  momentum_system (1e-5 / 1e-12 of each output's largest value) in every
  scheme and limiter family it takes, LINEAR and LINEAR_WEIGHTED face
  pressures, steady and transient, IMPLICIT and EXPLICIT relaxation, on
  the channel boxes, a relabelled write_tgrid box (RCM order), the
  windows of a 2-slab partition and slot tables off 16-byte boundaries;
  simple_step and simple_step_fc with it against the plain steps; and
  the launches the face-major steps make of it for each scheme.

Skips where g++ is missing. The card's own checks are in
tests/test_torch_gpu.py and chip_smoke.py.
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_kernel_refs import (
    jacobi_fma_chain,
    shift_spmv_fma_chain,
    slice_spmv_fma_chain,
)

import jax.numpy as jnp
from orc_tpu.mesh.reorder import build_slice_plan as jslice_plan
from orc_tpu.ops import spmv as jspmv

from orc_tpu_torch.mesh.compile import compile_from_arrays
from orc_tpu_torch.mesh.reorder import build_slice_plan
from orc_tpu_torch.models.cavity import cavity_case, flagship_settings
from orc_tpu_torch.models.channel_flow import ChannelFlowParameters, couette_case
from orc_tpu_torch.ops import _cuda
from orc_tpu_torch.ops import fused_assembly as asm
from orc_tpu_torch.ops import fused_smooth as fs
from orc_tpu_torch.ops import shift_spmv as sh
from orc_tpu_torch.ops import slice_spmv as ss
from orc_tpu_torch.ops.ck_ops import (
    build_ck_geometry,
    ck_bc,
    ck_pressure_gradient,
    ck_velocity_gradient,
)
from orc_tpu_torch.ops.fields import device_bc
from orc_tpu_torch.ops.spmv import EllMatrix
from orc_tpu_torch.utils import settings as tset

CSRC = Path(_cuda.__file__).resolve().parent.parent / "csrc"
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}

MOCK_CUDA_RUNTIME = r"""#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct uint4 {
  unsigned x, y, z, w;
};
inline thread_local dim3 blockIdx, threadIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "mock"; }
template <class T>
inline T __ldg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline double __dmul_rn(double a, double b) {
  volatile double r = a * b;
  return r;
}
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
using std::max;
using std::min;

inline std::barrier<>* mock_barrier = nullptr;
inline void __syncthreads() { mock_barrier->arrive_and_wait(); }
alignas(16) inline unsigned char mock_smem[1 << 20];

// Threads that run a block's threads, kept from launch to launch
// (creating 512 threads a block dominated the rehearsal's time). Never
// destroyed: the threads wait for work until the process exits.
struct MockPool {
  std::mutex m;
  std::condition_variable cv, done_cv;
  std::function<void(unsigned)> job;
  unsigned gen = 0, want = 0, finished = 0;
  std::vector<std::thread> threads;

  void run(unsigned n, std::function<void(unsigned)> f) {
    while (threads.size() < n) {
      const unsigned id = static_cast<unsigned>(threads.size());
      threads.emplace_back([this, id] {
        unsigned seen = 0;
        for (;;) {
          std::function<void(unsigned)> g;
          {
            std::unique_lock<std::mutex> l(m);
            cv.wait(l, [&] { return gen != seen && id < want; });
            seen = gen;
            g = job;
          }
          g(id);
          std::lock_guard<std::mutex> l(m);
          if (++finished == want) done_cv.notify_one();
        }
      });
    }
    {
      std::lock_guard<std::mutex> l(m);
      job = std::move(f);
      want = n;
      finished = 0;
      ++gen;
    }
    cv.notify_all();
    std::unique_lock<std::mutex> l(m);
    done_cv.wait(l, [&] { return finished == want; });
  }
};
inline MockPool& mock_pool() {
  static MockPool* pool = new MockPool;
  return *pool;
}

template <class K, class... A>
void mock_launch(dim3 grid, dim3 block, size_t smem, K kernel, A... args) {
  if (smem > sizeof(mock_smem)) std::abort();
  gridDim = grid;
  blockDim = block;
  const unsigned n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(n);
        mock_barrier = &bar;
        mock_pool().run(n, [&](unsigned t) {
          blockIdx = dim3(bx, by, bz);
          threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                           t / (block.x * block.y));
          kernel(args...);
          bar.arrive_and_drop();
        });
      }
}
"""

#: The sources rehearsed, each compiled on its own in parallel.
SOURCES = ("slice_spmv.cu", "parity_assembly.cu", "parity_assembly_f64.cu",
           "assembly.cu", "jacobi_sweeps.cu", "shift_spmv.cu", "fm_assembly.cu")


def _split_top(text):
    """`text` split at the commas outside parentheses."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def translate(src):
    """A CUDA source as C++ for the mock: `extern __shared__ T name[];`
    points at the mock's buffer, and `kernel<<<grid, block[, smem,
    stream]>>>(args)` becomes `mock_launch(dim3(grid), dim3(block),
    smem, kernel, args)`."""
    src = re.sub(
        r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?([\w ]+?)\s+(\w+)\[\];",
        r"\1* \2 = reinterpret_cast<\1*>(mock_smem);",
        src,
    )
    out, pos = [], 0
    for m in re.finditer(r"([A-Za-z_]\w*(?:<[^<>;()]*>)?)\s*<<<(.*?)>>>\(", src, re.S):
        cfg = _split_top(m.group(2))
        smem = cfg[2] if len(cfg) > 2 else "0"
        out += [
            src[pos:m.start()],
            f"mock_launch(dim3({cfg[0]}), dim3({cfg[1]}), "
            f"static_cast<size_t>({smem}), {m.group(1)}, ",
        ]
        pos = m.end()
    return "".join(out) + src[pos:]


@pytest.fixture(scope="module")
def mock_lib(tmp_path_factory):
    """The rehearsed sources as one shared library (g++, C++20)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources against the mock")
    d = tmp_path_factory.mktemp("mock_cuda")
    (d / "cuda_runtime.h").write_text(MOCK_CUDA_RUNTIME)
    for f in (*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")):
        (d / f.name).write_text(translate(f.read_text()))
    flags = ["-x", "c++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
             "-pthread", "-w", f"-I{d}"]
    objs = [d / f"{Path(s).stem}.o" for s in SOURCES]
    procs = [
        subprocess.Popen([gxx, *flags, "-c", "-o", str(o), str(d / s)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s, o in zip(SOURCES, objs)
    ]
    for p in procs:
        _out, err = p.communicate()
        assert p.returncode == 0, err
    lib_path = d / "libmock.so"
    subprocess.run([gxx, "-shared", "-pthread", "-o", str(lib_path), *map(str, objs)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("orc_slice_spmv", "orc_slice_spmv_exact", "orc_momentum_assembly",
                 "orc_pc_assembly", "orc_fc_momentum_assembly", "orc_fc_pc_assembly",
                 "orc_jacobi_sweeps",
                 "orc_jacobi_sweeps_rows", "orc_jacobi_march", "orc_shift_spmv",
                 "orc_shift_spmv_rows", "orc_fm_momentum_assembly"):
        fn = getattr(lib, name)
        fn.argtypes = _cuda.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture
def mock(mock_lib, monkeypatch):
    """Route the wrappers' `_cuda.call` to the mock library."""

    def call(name, device, *args):
        err = getattr(mock_lib, name)(*args, None)
        assert err == 0, f"{name} refused its arguments (error {err})"

    monkeypatch.setattr(_cuda, "call", call)
    return mock_lib


# --- the slice-plan SpMV ------------------------------------------------


def _permuted_cavity(n, dtype):
    """The n x n cavity with seeded permuted cells, compiled on the CPU:
    RCM order and a slice plan."""
    box, _ = cavity_case(n=n, device="cpu")
    a = lambda t: t.numpy()  # noqa: E731
    perm = np.random.default_rng(0).permutation(box.n_cells)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(box.n_cells)
    interior = a(box.face_interior)
    return compile_from_arrays(
        dim=3, face_owner=inv[a(box.face_owner)],
        face_neighbor=np.where(interior, inv[a(box.face_neighbor)], -1),
        face_area=a(box.face_area), face_normal=a(box.face_normal),
        face_centroid=a(box.face_centroid), face_zone_slot=a(box.face_zone_slot),
        cell_centroid=a(box.cell_centroid)[perm],
        cell_volume=a(box.cell_volume)[perm], dtype=dtype, device="cpu",
    )


#: name -> (n of the permuted n x n cavity, plan tile or None for the
#: mesh's own, batch rows, one matrix per batch row).
SLICE_CASES = {
    "cavity12": (12, None, 0, False),
    "cavity23_ragged_b3": (23, None, 3, False),
    "cavity23_per_row_b3": (23, None, 3, True),
    "cavity40_b5": (40, None, 5, False),
    "tile1024": (40, 1024, 0, False),
    "tile1024_b3": (40, 1024, 3, False),
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_slice_spmv_matches_plain(mock, dtype, case):
    """Guards orc_tpu/ops/pallas_slice.py `_kernel`, `_kernel_heavy` and
    `_kernel_wide` (via slice_spmv's kernel launch on the mock)."""
    n, tile, B, per_row = SLICE_CASES[case]
    mesh = _permuted_cavity(n, dtype)
    C, K = mesh.cell_neighbors.shape
    interior = mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask
    plan = mesh.slice_plan
    if tile is not None:
        plan = build_slice_plan(
            mesh.cell_neighbors.numpy(), interior.numpy(), tile=tile, device="cpu"
        )
        assert plan.tile == tile and C % tile != 0
    rng = np.random.default_rng(4)
    rows = (B,) if per_row else ()
    off = torch.tensor(rng.uniform(-1, 0, rows + (C, K)), dtype=dtype) * interior
    diag = 1.0 + off.abs().sum(-1) + torch.tensor(rng.random(rows + (C,)), dtype=dtype)
    A, _ = EllMatrix(diag, off, mesh.cell_neighbors, plan=plan).prepare().jacobi_preconditioned()
    x = torch.tensor(rng.standard_normal((B, C) if B else (C,)), dtype=dtype)
    y = ss._launch_slice_spmv(
        A.diag.contiguous(), ss._batch_stride(A.diag, 1, B, "diag"),
        A.off.contiguous(), ss._batch_stride(A.off, 3, B, "coef"), plan, x, max(B, 1),
    )
    ref = ss.slice_spmv_plain(A.diag, A.off, plan, x)
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= TOL[dtype] * scale
    if dtype == torch.float32:
        assert torch.equal(y, slice_spmv_fma_chain(A.diag, A.off, plan, x))
    # orc_tpu's XLA slice SpMV on its own plan of the same sparsity (equal
    # to the port's) and the same coefficients.
    jplan = jslice_plan(mesh.cell_neighbors.numpy(), interior.numpy(), tile=plan.tile)
    assert np.array_equal(np.asarray(jplan.starts), plan.starts.numpy())
    yj = np.asarray(jspmv.slice_spmv(
        jnp.asarray(A.diag.numpy()), jnp.asarray(A.off.numpy()), jplan,
        jnp.asarray(x.numpy()),
    ))
    np.testing.assert_allclose(y.numpy(), yj, rtol=0, atol=TOL[dtype] * scale)


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_rehearsed_slice_spmv_exact_is_bitwise_plain(mock, case):
    """Guards orc_tpu/ops/pallas_slice.py `_kernel_exact` and
    `_kernel_wide_exact` (via slice_spmv_exact's kernel launch on the
    mock): (y, err) bitwise equal to the plain version on the chunked
    CTAs, the batch sharing the matrix or one per row."""
    n, tile, B, per_row = SLICE_CASES[case]
    mesh = _permuted_cavity(n, torch.float64)
    C, K = mesh.cell_neighbors.shape
    interior = mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask
    plan = mesh.slice_plan
    if tile is not None:
        plan = build_slice_plan(
            mesh.cell_neighbors.numpy(), interior.numpy(), tile=tile, device="cpu"
        )
    rng = np.random.default_rng(6)
    rows = (B,) if per_row else ()
    off = torch.tensor(rng.uniform(-1, 0, rows + (C, K))) * interior
    diag = 1.0 + off.abs().sum(-1)
    coef = EllMatrix(diag, off, mesh.cell_neighbors, plan=plan).prepare().off.float()
    x = torch.tensor(rng.standard_normal((B, C) if B else (C,)), dtype=torch.float32)
    y, err = ss._launch_slice_spmv_exact(
        coef.contiguous(), ss._batch_stride(coef, 3, B, "coef"), plan, x, max(B, 1)
    )
    yr, er = ss.slice_spmv_exact_plain(coef, plan, x)
    assert torch.equal(y, yr) and torch.equal(err, er)
    assert float(err.abs().max()) > 0.0  # the error plane is not trivially 0


# --- the Jacobi sweeps ----------------------------------------------------

#: name -> (nx, ny, nz) of a structured box: ragged tiles on every side,
#: a box smaller than one tile, axes of extent 1.
SWEEP_BOXES = {
    "37x9": (37, 9, 1),
    "61x23": (61, 23, 1),
    "5x3": (5, 3, 1),
    "17x5x3": (17, 5, 3),
    "1x7x3": (1, 7, 3),
    "6x1x4": (6, 1, 4),
    "12x1x1": (12, 1, 1),
}
#: Sweeps fused a launch; a 3-D window 6 deep overflows a CTA.
SWEEP_DEPTHS = (1, 2, 6)


def _sweep_system(shape, B, dtype, periodic=()):
    """A structured box's offsets (padding columns included) and a seeded
    diagonally dominant system on them: coefficients on every column
    whose neighbour row lies in [0, C), the faces that cross the box's
    rows too."""
    from orc_tpu_torch.mesh.generate import structured_box_mesh

    mesh, _ = structured_box_mesh(*shape, periodic=periodic, device="cpu")
    offsets = tuple(int(o) for o in mesh.neighbor_offsets)
    C = mesh.n_cells
    rng = np.random.default_rng(sum(shape) + B)
    off = rng.uniform(-1.0, 0.0, (C, len(offsets)))
    c = np.arange(C)
    for k, d in enumerate(offsets):
        off[((c + d) < 0) | ((c + d) >= C), k] = 0.0
    diag = 1.0 + np.abs(off).sum(axis=1) + rng.random(C)
    rows = (B, C) if B > 1 else (C,)
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    cols = tuple(t(off[:, k]) for k in range(len(offsets)))
    return offsets, t(diag), cols, t(rng.standard_normal(rows)), t(rng.standard_normal(rows))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("depth", SWEEP_DEPTHS)
@pytest.mark.parametrize("box", sorted(SWEEP_BOXES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_tiled_sweeps_match_plain(mock, dtype, box, depth, B):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel` (via
    fused_jacobi_sweeps' tiled launch on the mock): six sweeps at
    `depth` sweeps a launch against the plain sweeps, bitwise against
    the per-sweep kernel (both spell out one rounding) and in float32
    bitwise against that rounding, emulated."""
    shape = SWEEP_BOXES[box]
    offsets, diag, cols, b, x0 = _sweep_system(shape, B, dtype)
    C = diag.shape[0]
    if depth == 6 and sum(n > 1 for n in shape) == 3:
        with pytest.raises(ValueError):
            fs.sweep_plan(offsets, C, 6, dtype, depth=depth)
        return
    plan = fs.sweep_plan(offsets, C, 6, dtype, depth=depth)
    want = tuple(n for n in shape if n > 1)
    assert plan.dims == want + (1,) * (3 - len(want))
    assert plan.launches(6, B) == -(-6 // depth)
    y = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, plan)
    ref = fs.sweeps_plain(diag, cols, offsets, b, x0, 6, 0.8)
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= TOL[dtype] * scale
    per_sweep = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, fs.SweepPlan())
    assert torch.equal(y, per_sweep)
    if dtype == torch.float32:
        assert torch.equal(y, jacobi_fma_chain(diag, cols, offsets, b, x0, 6, 0.8))


def test_rehearsed_sweep_plans(mock):
    """The instance each shape takes: all sweeps in one tiled launch on
    a 2-D box (an even split beyond MAX_DEPTH_2D, three batch rows a
    launch), the per-sweep kernel on 3-D and periodic boxes; the
    periodic box's sweeps on the mock against the plain sweeps."""
    f32 = torch.float32
    cavity = (-1024, -1, 1, 1024)
    plan = fs.sweep_plan(cavity, 1024 * 1024, 6, f32)
    assert (plan.depth, plan.dims, plan.launches(6, 3)) == (6, (1024, 1024, 1), 1)
    assert fs.sweep_plan(cavity, 1024 * 1024, 7, f32).launches(7, 3) == 1
    nine = fs.sweep_plan(cavity, 1024 * 1024, 9, f32)
    assert (nine.depth, nine.launches(9, 1), nine.launches(9, 4)) == (5, 2, 4)
    box3 = (-128 * 128, -128, -1, 1, 128, 128 * 128)
    march = fs.sweep_plan(box3, 128**3, 6, f32)
    assert (march.march, march.dims, march.per_row) == (True, (128, 128, 128), False)
    assert march.launches(6, 3) == -(-6 // fs.MARCH_DEPTH) and march.label().startswith("march")
    for S in range(1, fs.MAX_DEPTH_MARCH + 1):
        forced = fs.sweep_plan(box3, 128**3, 6, f32, depth=S, march=True)
        assert forced.launches(6, 3) == -(-6 // S) and forced.launches(6, 4) == 2 * -(-6 // S)
    assert fs.sweep_plan(box3, 128**3, 6, f32, per_row=True) == fs.SweepPlan(per_row=True)
    tvd = fs.sweep_plan(cavity, 1024 * 1024, 6, f32, per_row=True)
    assert (tvd.depth, tvd.per_row, tvd.launches(6, 3)) == (6, True, 1)
    assert tvd.label().startswith("tiled S=6 per-row")
    assert fs.sweep_plan(cavity, 1024 * 1024, 9, f32, per_row=True).launches(9, 3) == 2
    assert fs.sweep_plan(cavity[:3], 1024 * 1024, 6, f32) == fs.SweepPlan()
    for dt, cap in fs.TILE_WINDOW.items():
        bx, by, bz = fs.sweep_plan(cavity, 1024 * 1024, 6, dt).tile
        assert bz == 1 and (bx + 12) * (by + 12) <= cap
    offsets, diag, cols, b, x0 = _sweep_system((9, 6, 1), 3, torch.float64, periodic=("x", "y"))
    plan = fs.sweep_plan(offsets, diag.shape[0], 6, torch.float64)
    assert plan == fs.SweepPlan() and plan.launches(6, 3) == 6
    with pytest.raises(ValueError):
        fs.sweep_plan(offsets, diag.shape[0], 6, torch.float64, depth=6)
    for kw in (dict(march=True), dict(march=True, per_row=True)):
        with pytest.raises(ValueError):
            fs.sweep_plan(offsets, diag.shape[0], 6, torch.float64, **kw)
    y = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, plan)
    ref = fs.sweeps_plain(diag, cols, offsets, b, x0, 6, 0.8)
    assert float((y - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


#: name -> (nx, ny, nz, march tile (bx, by, bz)): 3-D boxes ragged in
#: x, y and z, each with more than one z-chunk.
MARCH_BOXES = {
    "17x5x3": (17, 5, 3, (7, 4, 2)),
    "13x7x5": (13, 7, 5, (5, 3, 2)),
}


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("box", sorted(MARCH_BOXES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_march_matches_plain(mock, dtype, box, depth, B):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel` (via
    fused_jacobi_sweeps' march on 3-D boxes, on the mock): six sweeps in
    marches `depth` sweeps deep over ragged xy tiles and z-chunks,
    against the plain sweeps (1e-5
    / 1e-12 of the largest value), bitwise against the per-sweep kernel
    and in float32 bitwise against the rounding both spell out."""
    nx, ny, nz, tile = MARCH_BOXES[box]
    offsets, diag, cols, b, x0 = _sweep_system((nx, ny, nz), B, dtype)
    ref = fs.sweeps_plain(diag, cols, offsets, b, x0, 6, 0.8)
    scale = float(ref.abs().max())
    per_sweep = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, fs.SweepPlan())
    picked = fs.sweep_plan(offsets, diag.shape[0], 6, dtype, depth=depth, march=True)
    assert picked.dims == (nx, ny, nz) and picked.launches(6, B) == -(-6 // depth)
    plan = fs.SweepPlan(depth, (nx, ny, nz), tile, march=True)
    y = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, plan)
    assert float((y - ref).abs().max()) <= TOL[dtype] * scale
    assert torch.equal(y, per_sweep)
    if dtype == torch.float32:
        assert torch.equal(y, jacobi_fma_chain(diag, cols, offsets, b, x0, 6, 0.8))


# --- rows 1 and 2 with one matrix per batch row ---------------------------

#: name -> (nx, ny, nz, periodic axes): 2-D and 3-D boxes with a ragged C
#: (C not a multiple of a thread's V rows) and a periodic box.
PER_ROW_BOXES = {
    "37x9": (37, 9, 1, ()),
    "17x5x3": (17, 5, 3, ()),
    "9x6_periodic": (9, 6, 1, ("x", "y")),
    "130x4": (130, 4, 1, ()),
}


def _per_row_system(box, B, dtype, boxes=PER_ROW_BOXES):
    """A seeded diagonally dominant system per batch row on the box's
    offsets (every column whose neighbour row lies in [0, C)): diag
    [B,C], K [B,C] columns (strided views of one [B,C,K] tensor, as
    `split_columns` gives them), b and x0 [B,C]."""
    from orc_tpu_torch.mesh.generate import structured_box_mesh

    nx, ny, nz, periodic = boxes[box]
    mesh, _ = structured_box_mesh(nx, ny, nz, periodic=periodic, device="cpu")
    offsets = tuple(int(o) for o in mesh.neighbor_offsets)
    C, K = mesh.n_cells, len(offsets)
    rng = np.random.default_rng(nx + ny + nz + B)
    off = rng.uniform(-1.0, 0.0, (B, C, K))
    c = np.arange(C)
    for k, d in enumerate(offsets):
        off[:, ((c + d) < 0) | ((c + d) >= C), k] = 0.0
    diag = 1.0 + np.abs(off).sum(axis=-1) + rng.random((B, C))
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    off = t(off)
    cols = tuple(off[..., k] for k in range(K))
    return offsets, t(diag), cols, t(rng.standard_normal((B, C))), t(rng.standard_normal((B, C)))


@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("box", sorted(PER_ROW_BOXES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_per_row_shift_spmv_matches_plain(mock, dtype, box, B):
    """Guards orc_tpu/ops/pallas_spmv.py `_kernel` (via shift_spmv's
    per-row launch on the mock): one matrix per batch row, strided and
    contiguous columns, against the plain version (1e-5 / 1e-12 of the
    largest value), in float32 bitwise against the rounding the source
    spells out; with B identical rows it equals the shared instance
    bitwise."""
    offsets, diag, cols, x, _ = _per_row_system(box, B, dtype)
    ref = sh.shift_spmv_plain(diag, cols, offsets, x)
    scale = float(ref.abs().max())
    for form in (cols, tuple(c.contiguous() for c in cols)):
        y = sh._launch_shift_spmv(diag, form, offsets, x)
        assert float((y - ref).abs().max()) <= TOL[dtype] * scale
        if dtype == torch.float32:
            assert torch.equal(y, shift_spmv_fma_chain(diag, form, offsets, x))
    same = sh._launch_shift_spmv(
        diag[:1].expand(B, -1), tuple(c[:1].expand(B, -1) for c in cols), offsets, x
    )
    shared = sh._launch_shift_spmv(diag[0].contiguous(), tuple(c[0] for c in cols), offsets, x)
    assert torch.equal(same, shared)


@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("box", sorted(PER_ROW_BOXES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_per_row_sweeps_match_plain(mock, dtype, box, B):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel` (via
    fused_jacobi_sweeps' per-sweep per-row launch on the mock, which
    3-D and periodic per-row systems take): six sweeps, one matrix per
    batch row, against the plain sweeps (1e-5 / 1e-12 of the largest
    value); with B identical rows it equals the shared per-sweep
    instance bitwise."""
    offsets, diag, cols, b, x0 = _per_row_system(box, B, dtype)
    plan = fs.sweep_plan(offsets, diag.shape[-1], 6, dtype, depth=0, per_row=True)
    assert plan.per_row and plan.label() == "per-sweep per-row"
    if PER_ROW_BOXES[box][2] > 1 or PER_ROW_BOXES[box][3]:
        assert fs.sweep_plan(offsets, diag.shape[-1], 6, dtype, per_row=True) == plan
    assert plan.launches(6, B) == 6
    y = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, plan)
    ref = fs.sweeps_plain(diag, cols, offsets, b, x0, 6, 0.8)
    assert float((y - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())
    same = fs._launch_sweeps(
        diag[:1].expand(B, -1), tuple(c[:1].expand(B, -1) for c in cols),
        offsets, b, x0, 6, 0.8, plan,
    )
    shared = fs._launch_sweeps(
        diag[0].contiguous(), tuple(c[0] for c in cols), offsets, b, x0, 6, 0.8,
        fs.SweepPlan(),
    )
    assert torch.equal(same, shared)


#: The 2-D boxes of PER_ROW_BOXES and a box whose tiles are ragged at
#: every depth.
PER_ROW_TILE_BOXES = {
    "37x9": PER_ROW_BOXES["37x9"],
    "130x4": PER_ROW_BOXES["130x4"],
    "61x45": (61, 45, 1, ()),
}


@pytest.mark.parametrize("depth", [1, 2, 6])
@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("box", sorted(PER_ROW_TILE_BOXES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_per_row_tiled_sweeps_match_plain(mock, dtype, box, B, depth):
    """Guards orc_tpu/ops/pallas_smooth.py `_kernel` (via
    fused_jacobi_sweeps' per-row tiles on the mock: a CTA per tile and
    batch row): six sweeps at `depth` sweeps a launch, one matrix per
    batch row, against the plain sweeps (1e-5 / 1e-12 of the largest
    value), bitwise against the per-sweep per-row kernel and in float32
    against the rounding both spell out; with B identical rows it equals
    the shared tiled instance bitwise."""
    offsets, diag, cols, b, x0 = _per_row_system(box, B, dtype, PER_ROW_TILE_BOXES)
    C = diag.shape[-1]
    plan = fs.sweep_plan(offsets, C, 6, dtype, depth=depth, per_row=True)
    assert plan.per_row and plan.launches(6, B) == -(-6 // depth)
    if box == "61x45":  # several tiles along x, the last one ragged
        assert 61 % plan.tile[0]
    y = fs._launch_sweeps(diag, cols, offsets, b, x0, 6, 0.8, plan)
    ref = fs.sweeps_plain(diag, cols, offsets, b, x0, 6, 0.8)
    assert float((y - ref).abs().max()) <= TOL[dtype] * float(ref.abs().max())
    per_sweep = fs._launch_sweeps(
        diag, cols, offsets, b, x0, 6, 0.8, fs.SweepPlan(per_row=True)
    )
    assert torch.equal(y, per_sweep)
    if dtype == torch.float32:
        assert torch.equal(y, jacobi_fma_chain(diag, cols, offsets, b, x0, 6, 0.8))
    same = fs._launch_sweeps(
        diag[:1].expand(B, -1), tuple(c[:1].expand(B, -1) for c in cols),
        offsets, b, x0, 6, 0.8, plan,
    )
    shared = fs._launch_sweeps(
        diag[0].contiguous(), tuple(c[0] for c in cols), offsets, b, x0, 6, 0.8,
        plan._replace(per_row=False),
    )
    assert torch.equal(same, shared)


# --- the parity momentum assembly ---------------------------------------

#: name -> (nx, ny, nz, velocity inlet or None for a pressure inlet).
BOXES = {
    "10x6_vinlet": (10, 6, 1, 1e-3),
    "6x5x4_vinlet": (6, 5, 4, 1e-3),
    "37x9_pressure": (37, 9, 1, None),
    "17x5x3_pressure": (17, 5, 3, None),
}
FAMILIES = {
    "ud": ("ud", None),
    "cd1": ("cd1", None),
    "tvd_dc-lud": ("tvd_dc", tset.tvd_lud),
    "tvd_dc-quick": ("tvd_dc", tset.tvd_quick),
    "tvd_dc-umist": ("tvd_dc", tset.tvd_umist),
}
#: (Rhie-Chow, SecondOrder, in-kernel gradient): every face model.
FACE_MODELS = (
    (False, False, False), (True, False, False), (True, False, True),
    (False, True, False), (False, True, True), (True, True, False),
    (True, True, True),
)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_momentum_matches_plain(mock, dtype, box, family):
    """Guards orc_tpu/ops/pallas_assembly.py `_momentum_kernel`, parity
    branch (via momentum_assembly's kernel launch on the mock), in every
    face-model instance of the family, steady and transient."""
    nx, ny, nz, vinlet = BOXES[box]
    mesh, table = couette_case(
        nx, ny, nz, params=ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=5.0),
        velocity_inlet=vinlet, dtype=dtype, device="cpu",
    )
    zc, zs, zv = device_bc(table, dtype=dtype, device="cpu")
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    cols = asm.column_specs(mesh, table)
    assert asm.box_dims(cols, mesh.n_cells) == (nx, ny, nz)
    C = mesh.n_cells
    rng = np.random.default_rng(3)
    vel = torch.tensor(rng.standard_normal((C, 3)) * 0.1, dtype=dtype)
    p = torch.tensor(rng.standard_normal(C) * 0.05, dtype=dtype)
    md = torch.tensor(rng.uniform(0.5, 2.0, C), dtype=dtype)
    grad_p = ck_pressure_gradient(mesh, ck, bc, p)
    grad_v = ck_velocity_gradient(mesh, ck, bc, vel)
    vel_n = torch.tensor(rng.standard_normal((C, 3)) * 0.1, dtype=dtype)
    margs = (vel, p, asm.bc_value_table(zs, zv), asm.pack_flags(ck.interior, ck.mask),
             cols, 1.0, 1e-3, 0.7)
    scheme, psi = FAMILIES[family]
    vol = float(mesh.cell_volume[0])
    for rc, p_so, gg in FACE_MODELS:
        spec = asm.AsmSpec(scheme=scheme, rc=rc, p_so=p_so, psi=psi, vol=vol, gg=gg)
        for inertia in (None, (1000.0 * mesh.cell_volume / 0.01, vel_n)):
            kw = dict(grad_p=None if gg else grad_p, mom_diag=md, grad_vel=grad_v,
                      inertia=inertia, spec=spec)
            got = asm._launch_momentum(*margs, *kw.values())
            ref = asm.momentum_assembly_plain(*margs, **kw)
            for name, a, r in zip(("diag", "off", "b"), got, ref):
                err = float((a - r).abs().max())
                assert err <= TOL[dtype] * float(r.abs().max()), (
                    f"{spec} inertia={inertia is not None} {name}: {err:.3e}"
                )


def _box_case(box, dtype):
    """A channel box of BOXES with seeded fields, compiled on the CPU:
    (mesh, cols, ck geometry, ck BC, BC value table, flags, fields)."""
    nx, ny, nz, vinlet = BOXES[box]
    mesh, table = couette_case(
        nx, ny, nz, params=ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=5.0),
        velocity_inlet=vinlet, dtype=dtype, device="cpu",
    )
    zc, zs, zv = device_bc(table, dtype=dtype, device="cpu")
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    cols = asm.column_specs(mesh, table)
    assert asm.box_dims(cols, mesh.n_cells) == (nx, ny, nz)
    C = mesh.n_cells
    rng = np.random.default_rng(3)
    f = dict(
        vel=torch.tensor(rng.standard_normal((C, 3)) * 0.1, dtype=dtype),
        p=torch.tensor(rng.standard_normal(C) * 0.05, dtype=dtype),
        md=torch.tensor(rng.uniform(0.5, 2.0, C), dtype=dtype),
        vel_n=torch.tensor(rng.standard_normal((C, 3)) * 0.1, dtype=dtype),
        flux=torch.tensor(rng.standard_normal((C, len(cols))) * 0.1, dtype=dtype),
    )
    f["grad_p"] = ck_pressure_gradient(mesh, ck, bc, f["p"])
    f["grad_v"] = ck_velocity_gradient(mesh, ck, bc, f["vel"])
    f["vol"] = float(mesh.cell_volume[0])
    bcv = asm.bc_value_table(zs, zv)
    return mesh, cols, bcv, asm.pack_flags(ck.interior, ck.mask), f


def _assert_close(got, ref, dtype, what):
    for name, a, r in zip(("diag", "off", "b"), got, ref):
        err = float((a - r).abs().max())
        assert err <= TOL[dtype] * float(r.abs().max()), f"{what} {name}: {err:.3e}"


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_fc_momentum_matches_plain(mock, dtype, box, family):
    """Guards orc_tpu/ops/pallas_assembly.py `_momentum_kernel`, SIMPLE_FC
    branch (via fc_momentum_assembly's kernel launch on the mock), with
    Linear and SecondOrder face pressures, steady and transient."""
    mesh, cols, bcv, flags, f = _box_case(box, dtype)
    flux = f["flux"].T.contiguous().T  # the planes layout of FlowState.flux
    margs = (f["vel"], f["p"], flux, bcv, flags, cols, 1.0, 1e-3, 0.7)
    scheme, psi = FAMILIES[family]
    for p_so in (False, True):
        spec = asm.AsmSpec(scheme=scheme, p_so=p_so, psi=psi)
        for inertia in (None, (1000.0 * mesh.cell_volume / 0.01, f["vel_n"])):
            kw = dict(grad_p=f["grad_p"], grad_vel=f["grad_v"], inertia=inertia, spec=spec)
            got = asm._launch_fc_momentum(*margs, *kw.values())
            ref = asm.fc_momentum_assembly_plain(*margs, **kw)
            _assert_close(got, ref, dtype, f"{spec} inertia={inertia is not None}")


@pytest.mark.parametrize("rc", [False, True], ids=["linear", "rc"])
@pytest.mark.parametrize("case", sorted(BOXES) + ["37x9_pressure-3slabs", "17x5x3_pressure-2slabs"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_fc_pc_matches_plain(mock, dtype, case, rc):
    """Guards orc_tpu/ops/pallas_assembly.py `_fc_pc_kernel` (via
    fc_pc_assembly's kernel launch on the mock), with Linear and
    Rhie-Chow predictors: on the boxes of BOXES (2-D and 3-D, one tile or
    several, ragged on every side) and on every window of a ragged slab
    partition (row0 > 0), each output against the plain version."""
    outputs = ("diag", "off", "b", "flux_h")
    if "slabs" in case:
        box, n = case.split("-")
        windows = list(_slab_windows(box, dtype, int(n[0]), ragged=True))
        assert any(w[1][3] for w in windows)
    else:
        mesh, cols, bcv, flags, f = _box_case(case, dtype)
        windows = [(mesh, None, cols, bcv, flags, f)]
    for _mesh, window, cols, bcv, flags, f in windows:
        spec = asm.AsmSpec(rc=rc, vol=f["vol"])
        pargs = (f["vel"], f["md"], bcv, flags, cols, 1.0, f["grad_p"] if rc else None, spec)
        got = asm._launch_fc_pc(*pargs, window)
        ref = asm.fc_pc_assembly_plain(*pargs)
        for name, a, r in zip(outputs, got, ref):
            err = float((a - r).abs().max())
            assert err <= TOL[dtype] * float(r.abs().max()), f"{case} {window} {name}: {err:.3e}"


#: pc_kernel's instances: (Rhie-Chow, in-kernel gradient).
PC_INSTANCES = {"linear": (False, False), "rc-gg": (True, True), "rc-streamed": (True, False)}


@pytest.mark.parametrize("instance", sorted(PC_INSTANCES))
@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_pc_matches_plain(mock, dtype, box, instance):
    """Guards orc_tpu/ops/pallas_assembly.py `_pc_kernel` (via
    pc_assembly's kernel launch on the mock) in each of its instances."""
    mesh, cols, bcv, flags, f = _box_case(box, dtype)
    rc, gg = PC_INSTANCES[instance]
    spec = asm.AsmSpec(rc=rc, gg=gg, vol=float(mesh.cell_volume[0]))
    pargs = (f["vel"], f["md"], bcv, flags, cols, 1.0, f["p"] if rc else None,
             None if gg else f["grad_p"], spec)
    got = asm._launch_pc(*pargs)
    ref = asm.pc_assembly_plain(*pargs[:-1], spec=spec)
    _assert_close(got, ref, dtype, str(spec))


@pytest.mark.parametrize(
    "shape", [(10, 6, 1), (6, 5, 4), (1, 7, 3), (12, 1, 1)], ids=lambda s: "x".join(map(str, s))
)
def test_box_dims_tiles_axes_of_extent_one_last(shape):
    """The box the momentum kernel tiles: orc_tpu's `infer_box_dims` of
    the columns' offsets, axes of extent 1 moved last (a row of cells
    keeps its order); offsets that describe no box raise."""
    from orc_tpu_torch.mesh.generate import structured_box_mesh

    mesh, _ = structured_box_mesh(*shape, device="cpu")
    offsets = tuple(int(o) for o in mesh.neighbor_offsets)
    cols = tuple(asm.ColumnSpec(o, 1.0, (1.0, 0.0, 0.0), 0.5, 1.0, "wall", 0) for o in offsets)
    want = tuple(d for d in shape if d > 1)
    assert asm.box_dims(cols, mesh.n_cells) == want + (1,) * (3 - len(want))
    bad = (asm.ColumnSpec(5, 1.0, (1.0, 0.0, 0.0), 0.5, 1.0, "wall", 0),) + cols[1:]
    with pytest.raises(ValueError):
        asm.box_dims(bad, mesh.n_cells + 1)


def _slab_windows(box, dtype, n_parts, ragged):
    """The windows of a slab partition of a channel box of BOXES, one
    more plane along its slowest axis with `ragged` (owned ranges that
    start and end inside planes, row0 > 0): for each partition (local
    mesh, its box from parallel/sharded.slab_kernel_box, cols, BC value
    table, flags, seeded fields, its ck geometry as f["ck"] and the
    real cells' volume as f["vol"])."""
    from orc_tpu_torch.parallel.partition import partition_mesh
    from orc_tpu_torch.parallel.sharded import slab_kernel_box

    nx, ny, nz, _ = BOXES[box]
    shape = (
        (nx, ny * n_parts + ragged, nz) if nz == 1 else (nx, ny, nz * n_parts + ragged)
    )
    mesh, table = couette_case(
        *shape, params=ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=5.0),
        dtype=dtype, device="cpu",
    )
    cols = asm.column_specs(mesh, table)
    part = partition_mesh(mesh, n_parts, method="slab")
    zc, zs, zv = device_bc(table, dtype=dtype, device="cpu")
    bcv = asm.bc_value_table(zs, zv)
    rng = np.random.default_rng(5)
    for lmesh, window in zip(part.local_meshes, slab_kernel_box(mesh, part, cols)):
        L = lmesh.n_cells
        ck = build_ck_geometry(lmesh, len(table.zone_ids))
        bc = ck_bc(ck, zc, zs, zv)
        f = dict(
            vel=torch.tensor(rng.standard_normal((L, 3)) * 0.1, dtype=dtype),
            p=torch.tensor(rng.standard_normal(L) * 0.05, dtype=dtype),
            md=torch.tensor(rng.uniform(0.5, 2.0, L), dtype=dtype),
            flux=torch.tensor(rng.standard_normal((len(cols), L)) * 0.1, dtype=dtype).T,
            ck=ck,
            vol=float(mesh.cell_volume[0]),
        )
        f["grad_p"] = ck_pressure_gradient(lmesh, ck, bc, f["p"])
        f["grad_v"] = ck_velocity_gradient(lmesh, ck, bc, f["vel"])
        yield lmesh, window, cols, bcv, asm.pack_flags(ck.interior, ck.mask), f


@pytest.mark.parametrize("ragged", [False, True], ids=["planes", "ragged"])
@pytest.mark.parametrize("n_parts", [2, 3])
@pytest.mark.parametrize("box", ["37x9_pressure", "17x5x3_pressure"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_slab_windows_match_plain(mock, dtype, box, n_parts, ragged):
    """The window of each slab partition: rows 3, 4 and 5 given the box
    parallel/sharded.slab_kernel_box computes against their plain
    versions on every row of the window (the trash row included), halo
    values refreshed (here: any values) and the ghost and padding rows
    inactive. With `ragged`, the mesh has one plane more, so the owned
    ranges start and end inside planes (row0 > 0)."""
    windows = list(_slab_windows(box, dtype, n_parts, ragged))
    assert len(windows) == n_parts
    assert any(w[1][3] for w in windows) == ragged
    for lmesh, window, cols, bcv, flags, f in windows:
        L, vol, ck = lmesh.n_cells, f["vol"], f["ck"]
        vel, p, md, flux = f["vel"], f["p"], f["md"], f["flux"]
        grad_p, grad_v = f["grad_p"], f["grad_v"]
        # A row with an interior face onto a ghost row reads that row's
        # gradient, which the in-kernel instances form from the ghost's
        # own (inactive) flags where the plain version has zero: orc_tpu's
        # gate turns the in-kernel gradient off under sharding for that
        # reason. Those instances are held on the other rows.
        nbr = (torch.arange(L)[:, None] + torch.tensor([c.offset for c in cols])).clamp(0, L - 1)
        keep = ~(ck.interior & ~ck.mask.any(dim=1)[nbr]).any(dim=1)

        def rows(out, gg):
            return out if not gg else (out[0][keep], out[1][keep], out[2][..., keep])

        for scheme, psi, gg in (
            ("cd1", None, False), ("tvd_dc", tset.tvd_umist, False), ("cd1", None, True)
        ):
            spec = asm.AsmSpec(scheme=scheme, rc=True, p_so=True, psi=psi, vol=vol, gg=gg)
            margs = (vel, p, bcv, flags, cols, 1.0, 1e-3, 0.7)
            kw = dict(grad_p=None if gg else grad_p, mom_diag=md, grad_vel=grad_v,
                      inertia=None, spec=spec)
            got = asm._launch_momentum(*margs, *kw.values(), window)
            ref = asm.momentum_assembly_plain(*margs, **kw)
            _assert_close(rows(got, gg), rows(ref, gg), dtype, "momentum")
            if gg:
                continue
            fargs = (vel, p, flux, bcv, flags, cols, 1.0, 1e-3, 0.7)
            fkw = dict(grad_p=grad_p, grad_vel=grad_v, inertia=None,
                       spec=spec._replace(rc=False))
            got = asm._launch_fc_momentum(*fargs, *fkw.values(), window)
            _assert_close(got, asm.fc_momentum_assembly_plain(*fargs, **fkw), dtype, "fc")
        for rc, gg in ((False, False), (True, True), (True, False)):
            spec = asm.AsmSpec(rc=rc, vol=vol, gg=gg)
            pargs = (vel, md, bcv, flags, cols, 1.0, p if rc else None,
                     grad_p if rc and not gg else None, spec)
            got = asm._launch_pc(*pargs, window)
            ref = asm.pc_assembly_plain(*pargs[:-1], spec=spec)
            _assert_close(rows(got, gg), rows(ref, gg), dtype, "pc")
        assert float(got[0][-1]) == 1.0 and not got[1][-1].any() and float(got[2][-1]) == 0.0


# --- the face-major momentum assembly -------------------------------------

#: The meshes of the face-major kernel's cases: the channel boxes, a
#: relabelled write_tgrid box (RCM order, a slice plan, K = 6), the two
#: windows of a 2-slab partition of the 37 x 9 channel, and the 10 x 6
#: channel with its slot tables off 16-byte boundaries (one load a slot).
FM_CASES = sorted(BOXES) + ["irregular", "37x9_pressure-2slabs", "10x6_vinlet-unaligned"]
FM_SCHEMES = {
    "ud": tset.MomentumScheme.UD,
    "cd1": tset.MomentumScheme.CD1,
    "tvd_dc": tset.MomentumScheme.TVD_DC,
}


def _off_boundary(t):
    """A copy of `t` whose storage starts one element past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.fixture(scope="module")
def fm_meshes(tmp_path_factory):
    """case, dtype -> the [(mesh, table)] of FM_CASES, built once."""
    from torch_parity import relabelled_tgrid

    from orc_tpu_torch.mesh.tgrid import read_mesh
    from orc_tpu_torch.mesh.zones import FaceCondition
    from orc_tpu_torch.parallel.partition import partition_mesh

    cache = {}

    def get(case, dtype):
        if (case, dtype) in cache:
            return cache[case, dtype]
        if case == "irregular":
            path = relabelled_tgrid(tmp_path_factory.mktemp("fm"), 9, seed=3)
            mesh, table = read_mesh(str(path), dtype=dtype, device="cpu")
            assert mesh.neighbor_offsets is None and mesh.cell_order is not None
            table.set("INLET", FaceCondition.VELOCITY_INLET, vector_value=(1e-3, 0, 0))
            table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.01)
            table.set("TOP_WALL", FaceCondition.WALL, vector_value=(5e-4, 0, 0))
            out = [(mesh, table)]
        else:
            box, _, variant = case.partition("-")
            nx, ny, nz, vinlet = BOXES[box]
            mesh, table = couette_case(
                nx, ny, nz,
                params=ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=5.0),
                velocity_inlet=vinlet, dtype=dtype, device="cpu",
            )
            out = [(mesh, table)]
            if variant.endswith("slabs"):
                part = partition_mesh(mesh, int(variant[0]), method="slab")
                out = [(lmesh, table) for lmesh in part.local_meshes]
            elif variant == "unaligned":
                out = [(dataclasses.replace(mesh, **{
                    k: _off_boundary(getattr(mesh, k))
                    for k in ("cell_faces", "cell_neighbors", "cell_face_sign",
                              "cell_face_mask")
                }), table)]
        cache[case, dtype] = out
        return out

    return get


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("case", FM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rehearsed_fm_momentum_matches_plain(mock, fm_meshes, dtype, case, family):
    """The face-major momentum kernel (csrc/fm_assembly.cu, through
    fm_momentum_assembly on the mock) against face_pressure +
    momentum_system, each output to 1e-5 / 1e-12 of its largest value:
    LINEAR and LINEAR_WEIGHTED face pressures, steady and with the
    inertia term, IMPLICIT and EXPLICIT relaxation, on every mesh of
    FM_CASES (padded ghost and trash rows of the slab windows
    included)."""
    from orc_tpu_torch.ops import fm_assembly as fm
    from orc_tpu_torch.ops.assembly import diffusion_system
    from orc_tpu_torch.ops.fields import face_bc

    scheme, psi = FAMILIES[family]
    for mesh, table in fm_meshes(case, dtype):
        C = mesh.n_cells
        zc, zs, zv = device_bc(table, dtype=dtype, device="cpu")
        fbc = face_bc(mesh, zc, zs, zv)
        diff = diffusion_system(mesh, fbc, torch.tensor(1e-3, dtype=dtype))
        if case.endswith("unaligned"):
            diff = diff._replace(off=_off_boundary(diff.off))
        rng = np.random.default_rng(7)
        t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
        vel, vel_n = t(rng.standard_normal((C, 3)) * 0.1), t(rng.standard_normal((C, 3)) * 0.1)
        p, flux = t(rng.standard_normal(C) * 0.05), t(rng.standard_normal(mesh.n_faces) * 0.1)
        grad_v = t(rng.standard_normal((C, 3, 3)))
        for pi in (tset.PressureInterpolation.LINEAR, tset.PressureInterpolation.LINEAR_WEIGHTED):
            for mode in tset.RelaxationMode:
                s = tset.NumericalSettings(
                    momentum=FM_SCHEMES[scheme], tvd_psi=psi, pressure_interpolation=pi,
                    relaxation_mode=mode, momentum_relaxation=0.7,
                )
                assert fm.takes(s, dtype)
                for inertia in (None, (1000.0 * mesh.cell_volume / 0.01, vel_n)):
                    args = (mesh, fbc, s, 1.0, vel, flux, p, diff)
                    kw = dict(grad_vel=grad_v, inertia=inertia)
                    A, b, pe = fm.fm_momentum_assembly(*args, **kw)
                    R, rb, rpe = fm.fm_momentum_plain(*args, **kw)
                    assert A.off.shape == R.off.shape and A.off.T.is_contiguous()
                    for name, a, r in (("diag", A.diag, R.diag), ("off", A.off, R.off),
                                       ("b", b, rb), ("pe", pe, rpe)):
                        err = float((a - r).abs().max())
                        assert err <= TOL[dtype] * float(r.abs().max()), (
                            f"{family} {pi.value} {mode.value} "
                            f"inertia={inertia is not None} {name}: {err:.3e}"
                        )


def _fm_run(case, settings, iterations, kernel, monkeypatch):
    """`iterations` face-major steps of a 16 x 8 f64 case from its seeded
    start, with the face-major momentum kernel on the mock (`kernel`) or
    the plain ops: the final state and the launches made."""
    from orc_tpu_torch.ops import fm_assembly as fm
    from orc_tpu_torch.solver import simple as ts

    with monkeypatch.context() as m:
        if kernel:
            m.setattr(ts, "_on_cuda", lambda mesh: True)
        if case == "cavity":
            mesh, table = cavity_case(n=16, dtype=torch.float64, device="cpu")
        else:
            mesh, table = couette_case(
                16, 8, 1, params=ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=5.0),
                velocity_inlet=1e-3, dtype=torch.float64, device="cpu",
            )
        state = ts.initial_state(mesh)
        g = torch.Generator().manual_seed(11)
        state = dataclasses.replace(
            state,
            vel=state.vel + 1e-4 * torch.rand(state.vel.shape, generator=g, dtype=torch.float64),
        )
        fm.fm_momentum_assembly.launches = 0
        out, _ = ts.solve_steady(
            mesh, table, settings, 1.0, 1e-3 if case == "couette" else 1e-2, state=state,
            iterations=iterations, verbose=False, check_divergence=False, use_ck=False,
        )
        return out, fm.fm_momentum_assembly.launches


_JACOBI_P = tset.MatrixSolverSettings(
    solver_type=tset.SolutionMethod.JACOBI, iterations=50,
    preconditioner=tset.PreconditionMethod.JACOBI,
)
#: Face-major runs the kernel takes: the flagship SIMPLE_FC numerics
#: (TVD_DC + UMIST, Rhie-Chow, LINEAR_WEIGHTED p) and SIMPLE with UD and
#: linear faces under explicit relaxation; Jacobi pressure solves, which
#: do not amplify roundoff as BiCGSTAB does.
FM_STEPS = {
    "simple_fc-cavity": ("cavity", lambda: flagship_settings().replace(matrix_solver=_JACOBI_P)),
    "simple-couette": ("couette", lambda: tset.NumericalSettings(
        momentum=tset.MomentumScheme.UD,
        pressure_interpolation=tset.PressureInterpolation.LINEAR_WEIGHTED,
        matrix_solver=_JACOBI_P)),
}


@pytest.mark.parametrize("name", sorted(FM_STEPS))
def test_rehearsed_fm_kernel_steps_track_plain(mock, name, monkeypatch):
    """simple_step_fc and simple_step with the face-major momentum kernel
    (on the mock) against the plain steps over 6 iterations, float64: one
    launch an iteration, the final fields within 1e-9 of their scale."""
    case, make = FM_STEPS[name]
    settings = make()
    plain, n0 = _fm_run(case, settings, 6, False, monkeypatch)
    got, n = _fm_run(case, settings, 6, True, monkeypatch)
    assert (n0, n) == (0, 6)
    for f in ("vel", "p", "mom_diag") + (("flux",) if plain.flux is not None else ()):
        a, r = getattr(got, f), getattr(plain, f)
        err = float((a - r).abs().max())
        assert err <= 1e-9 * float(r.abs().max()), f"{f}: {err:.3e}"


#: settings -> launches an iteration of the face-major momentum kernel.
FM_DISPATCH = {
    "ud": (dict(momentum=tset.MomentumScheme.UD), 1),
    "cd1-linear": (dict(momentum=tset.MomentumScheme.CD1,
                        pressure_interpolation=tset.PressureInterpolation.LINEAR), 1),
    "tvd_dc-quick": (dict(momentum=tset.MomentumScheme.TVD_DC, tvd_psi=tset.tvd_quick), 1),
    "tvd_dc-implicit": (dict(momentum=tset.MomentumScheme.TVD_DC, tvd_psi=tset.tvd_umist,
                             relaxation_mode=tset.RelaxationMode.IMPLICIT), 1),
    "tvd_dc-own-limiter": (dict(momentum=tset.MomentumScheme.TVD_DC,
                                tvd_psi=lambda r: torch.clamp(r, 0.0, 1.0)), 0),
    "cd2": (dict(momentum=tset.MomentumScheme.CD2), 0),
    "tvd": (dict(momentum=tset.MomentumScheme.TVD, tvd_psi=tset.tvd_umist), 0),
    "second_order": (dict(momentum=tset.MomentumScheme.UD,
                          pressure_interpolation=tset.PressureInterpolation.SECOND_ORDER), 0),
}


@pytest.mark.parametrize("name", sorted(FM_DISPATCH))
def test_fm_kernel_dispatch_counts_launches(mock, name, monkeypatch):
    """`fm_momentum_assembly.launches` counts one launch an iteration of
    the face-major step on a CUDA mesh (the gate patched to the CPU mesh,
    the kernel on the mock) for the shared-matrix schemes with linear
    face pressures, and none for CD2, in-matrix TVD, SECOND_ORDER face
    pressures or a limiter without a kernel code; none on a CPU mesh."""
    kw, per_iter = FM_DISPATCH[name]
    settings = tset.NumericalSettings(**{
        "pressure_interpolation": tset.PressureInterpolation.LINEAR_WEIGHTED,
        "matrix_solver": _JACOBI_P, **kw,
    })
    _, n = _fm_run("couette", settings, 2, True, monkeypatch)
    assert n == 2 * per_iter
    _, n = _fm_run("couette", settings, 2, False, monkeypatch)
    assert n == 0


def test_chip_smoke_fm_phase_rehearsed(mock, monkeypatch):
    """chip_smoke's row-13 phase (phase_fm_kernels) on the CPU, with the
    kernel on the mock, its cavities cut to 16^2 and 16^2 x 6 and the
    card timings left out: it keeps the face-major step's operands, finds
    the kernel within TOL of fm_momentum_plain in each of its five
    comparisons (the flagship cavity timed) and two launches bitwise
    equal."""
    from torch_parity import chip_smoke

    from orc_tpu_torch.models import cavity

    cs = chip_smoke()

    real = cavity.cavity_case
    monkeypatch.setattr(
        cavity, "cavity_case", lambda n=16, nz=1, **kw: real(n=16, nz=min(nz, 6), **kw)
    )
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    seen = []

    def compare(self, label, kernel_call, plain_call, dtype, nbytes, timed,
                outputs=("y",), **kw):
        _, rels = cs.max_err(kernel_call(), plain_call())
        assert len(rels) == len(outputs) == 4 and nbytes > 0
        assert all(r <= cs.TOL[dtype] for r in rels), (label, rels)
        seen.append((label, timed))

    monkeypatch.setattr(cs.Kernel, "compare", compare)
    fm = cs.all_kernels()[-1]
    assert fm.name == "fm_momentum_assembly"
    cs.phase_fm_kernels(torch.device("cpu"), fm)
    assert [t for _, t in seen] == [True, False, False, False, False]
    assert seen[1][0].endswith("transient")
