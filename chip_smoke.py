"""Drive orc_tpu_torch's main path on one NVIDIA GPU and check it.

Usage (from the repository root, on a machine with a CUDA GPU):

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
1. device: the card's name and power limit, TF32 off;
2. build: compile csrc/*.cu into build/orc_tpu_torch/ (one nvcc per
   source, in parallel) and print each kernel's registers and spills;
3. each of the CUDA kernels against its plain torch version at the
   shapes of the main paths (the two momentum kernels also in their
   transient instances, with the inertia term), with times per call (CUDA events, host
   dispatch included; and the card's own time, the calls queued behind
   a sleeping kernel, which the summary reports), the bound (bytes
   over 3.35 TB/s, or operations over the peak rate) and, for the SpMVs
   and the gather, the one PyTorch call computing the same function
   (torch.sparse CSR times x; x[cell_neighbors]), each line with its
   share of 3.35 TB/s: the shift SpMV on the 1024^2 f32 cavity's
   pressure system (B = 1 and 3), the 128x64 f64 couette's (B = 1 and 3)
   and a K = 6 system of the 128^3 cavity's shape, the Jacobi sweeps
   (six) on the 1024^2 cavity's momentum system (B = 3 and 1), on the
   couette's shape (f64, B = 3) and on the 128^3 shape (B = 3: the
   z-march, timed, held bitwise to the launch per sweep, which is timed
   beside it), each with the kernel instance it takes (tiled and its
   depth, marching, or a launch per sweep), the parity kernels on
   the 1024^2 f32 cavity (UD, steady and transient), their Rhie-Chow /
   SecondOrder / TVD_DC / in-kernel-gradient branches on the
   reference-default 1024^2 f32 cavity (CD1 + SO + RC + GG also
   transient), the SIMPLE_FC assembly kernels on the 1024^2 f32
   flagship-numerics cavity and the 128x64 f64 FC couette (the momentum
   kernel also transient in both), the
   slice-plan SpMV and neighbour gather on the permuted 448^2 and 1024^2
   f32 cavities, the permuted 448^2 f64 cavity and the permuted 128x64
   f64 couette, the exact slice product of the df32 residual on the
   permuted 448^2 cavity (bitwise, beside the f64 slice SpMV it stands
   in for) and, with the slice SpMV in each form the DF32_IR phase runs
   it, on scripts/bench_df32_ir.py's system (1024-row tiles); the
   per-row branches of the shift SpMV (with the block-diagonal CSR
   product) and of the Jacobi sweeps (the per-row tiles, held bitwise to
   the per-sweep per-row kernel, which is timed beside them) on the
   1024^2 f32 TVD cavity's momentum system (B = 3, one matrix per
   component), both also on the 128x64 f64 CD2 couette's; the slice-plan
   SpMV on the coarse plans of the algebraic multigrid hierarchy of the
   permuted 448^2 f32 cavity (levels whose 128-row plan would be
   degenerate gather instead, as in orc_tpu; each level's form printed);
   the shift SpMV on `bench`'s extended line-1 system (the 1024^2
   box's [C,K] form, six offsets, two of them 0), whose card time phase
   23e holds the line to; and row 13, the face-major momentum assembly,
   on the operands of the face-major step at the shapes of phase 21's
   paths that launch it (the 1024^2 f32 cavity under the flagship
   numerics, steady and transient, and under solve_cavity's; the 216^3
   f32 cube; a 128x64 f64 couette under CD1 and linear face
   pressures), two launches bitwise equal;
3b. the SIMPLE and SIMPLE_FC slices on the card against the same slices
   on the CPU on a 16^2 float64 cavity (the parity one with
   solve_cavity's and with the reference's default numerics), and the FC
   flux's conservation; the same on a permuted 16^2 cavity (the
   irregular path), the parity one also with DF32_IR solves; the
   transient slice under both couplings (3 steps x 4 inner iterations)
   and the parity slice under MULTIGRID, card against CPU; the RANS
   channel 16x12 (10 iterations; k, eps and mu_t too) and the 16^2
   cavity under least squares with in-matrix TVD and with CD2,
   structured and permuted, card against CPU; the face-major step
   (use_ck=False): the reference-default cavity, structured and
   permuted, SIMPLE_FC with a Jacobi(50) pressure solve, the transient
   slice, and node-based Green-Gauss on a 16^2 TGRID cavity read with
   read_mesh(nodes=True), structured and with relabelled cells, each
   card against CPU to 1e-9 with equal inner counts; the permuted 16^2
   cavity under MULTIGRID (the algebraic hierarchy), the 16^2 cavity
   under GAUSS_SEIDEL, initialize_flow on a 64x32 velocity-inlet channel
   and solve_steady_with_recovery on tests/test_aux.py's diverging case
   (the same recovery log), card against CPU to 1e-9;
4. couette 128x64x1 float64 with bench.py's configuration (parity
   SIMPLE) through solve_steady: 100 warm-up + 200 timed iterations,
   u_mean within 25% of the analytical 1.0833e-3;
5. lid-driven cavity 1024^2 float32 with solve_cavity's configuration
   (parity SIMPLE) at Re = 1000: 10 warm-up + 50 timed iterations,
   finite |u| < 2;
6. SIMPLE_FC couette 128x64x1 float64 with the FC residual fixture's
   settings: 100 warm-up + 500 timed iterations, u_mean within 1e-6 of
   orc_tpu's after those 600 iterations (the implicitly relaxed FC loop
   develops the flow slowly: orc_tpu is 48% short of the analytical
   value at 600 iterations);
7. SIMPLE_FC cavity 1024^2 float32 with the Ghia flagship numerics at
   Re = 1000: 10 warm-up + 50 timed iterations from cold, finite
   |u| < 2;
8. solve_steady_sequenced 64^2 -> 128^2 float32, flagship numerics, 100
   iterations per level, finite fields;
9. scripts/bench_irregular_simple.py's configuration: the 448^2 cavity
   with randomly permuted cells (RCM order, slice plan), f32, forced
   SIMPLE, 5 warm-up + 25 timed iterations; 9b its structured twin the
   same way, the ms/iter ratio, and the fields mapped back to box order
   against the twin's;
10. the permuted couette 128x64x1 float64 with bench.py's configuration:
   100 warm-up + 200 timed iterations, u_mean within 25% of the
   analytical value and against phase 4's u_mean;
11. the reference-default cavity (scripts/bench_cavity.py with
   ORC_TPU_BENCH_SCHEME=default): 1024^2 f32, CD1 + SecondOrder +
   Rhie-Chow, forced SIMPLE, 10 warm-up + 50 timed iterations, finite
   |u| < 2, each parity assembly kernel launched once per iteration and
   no plain grad-p pass;
12. DF32_IR: scripts/bench_df32_ir.py's system (f32, DF32_IR and native
   f64 solves; DF32_IR below 1e-11 of x_true), then the permuted 448^2
   f64 cavity with DF32_IR against native f64 solves, and against native
   f64 solves as deep as DF32_IR's, which it must track;
13. the transient lid-driven cavity 1024^2 f32 from rest at Re = 1000,
   dt = 1/1024 (lid Courant number 1), solve_cavity's numerics: 10 steps
   x 10 inner iterations, ms per inner iteration, finite |u| < 2, the
   parity kernels (momentum in its transient instance) once per inner
   iteration;
14. the same with the Ghia flagship numerics (SIMPLE_FC, implicit 0.6 /
   0.03), 5 x 10, the SIMPLE_FC kernels once per inner iteration;
15. the 3-D cavity 128^3 f32 at Re = 100 (scripts/bench_cavity.py 128
   f32 128 100), 20 iterations under 5-level geometric MULTIGRID with 4
   smoother iterations, then its BiCGSTAB(50) twin: MULTIGRID's mean
   pressure iterations below the twin's, finite fields;
16. the Taylor-Green vortex 256^2 f64, 20 steps x 10 inner iterations,
   within 5e-3 of the exact decay;
17. k-epsilon RANS: the developing channel 1024x512x1 f32 with
   tests/test_turbulence.py's geometry, boundary conditions and SETTINGS
   under implicit relaxation (the test's explicit relaxation diverges on
   meshes finer than its own, in orc_tpu too), 10 warm-up + 30 timed
   iterations, finite fields, k > 0, mu_t <= 1e5 mu, the split between
   the SIMPLE step and turbulence_step;
18. the Re_tau = 590 channel 4x16 f64, 800 iterations, with the test's
   parity settings (held to its DNS bars) and under SIMPLE_FC, implicit
   0.6 / 0.3 (held to orc_tpu's profile, ORC_TPU_RE_TAU_FC_U_PROFILE_800);
19. least squares at 1024^2 f32: the reference-default cavity (the
   parity kernels' streamed-gradient instances once per iteration) and
   the SIMPLE_FC flagship (rows 4 and 6 fed least-squares gradients), 10
   warm-up + 50 timed iterations each, with the least-squares pieces
   timed on the card;
20. one matrix per velocity component: the 1024^2 f32 cavity with
   in-matrix TVD at Re = 100 (row 2's per-row instance; at Re = 1000
   in-matrix TVD diverges, in orc_tpu too) and bench.py's couette with
   CD2 (row 1's), the latter's u_mean within 25% of the analytical value;
21. the face-major step, which assembles its momentum systems in row 13
   where it takes the settings (b-e), in plain ops (as orc_tpu's does)
   otherwise and for the rest, and solves through rows 1, 2 and 7, with
   row 13 once an iteration: (a) fm-couette (CD1 under SECOND_ORDER face
   pressures, so no row 13), phase 4's couette
   with use_ck=False, 100 + 200 iterations, u_mean within 25% of the
   analytical value and within 1e-4 of phase 4's; (b) fm-cavity-1M,
   phase 5's cavity with use_ck=False, 10 + 50 iterations, finite
   |u| < 2, the same Jacobi-sweep instance and launches per iteration
   as phase 5; (c) fm-fc-cavity-1M, phase 7's with use_ck=False, 10 + 50
   from cold, the flux divergence equal to minus the pressure solve's
   residual, the median pressure residual within twice phase 7's; (d)
   ggnode-448, a
   448^2 TGRID cavity with relabelled cells read with
   read_mesh(nodes=True) (RCM order, slice plan, vertex tables), GG node
   under use_ck="auto", 5 + 25 iterations; (e) fm-auto-216, the 216^3 f32
   cavity above CK_AUTO_MAX_CELLS under "auto", 3 + 5 iterations, its
   build seconds and peak memory;
22. the solvers and drivers of slice 13: (a) amg-448, phase 9's permuted
   448^2 f32 cavity with MULTIGRID on the pressure system (the algebraic
   hierarchy at the settings' defaults: 3 levels, STRONGEST, coarsest
   16; its host build timed alone), 5 + 25 iterations beside its
   BiCGSTAB(50) twin, finite |u| < 2; (b) gs-cavity-1M, phase 5's cavity
   with the pressure solved by GAUSS_SEIDEL(50) over the greedy colouring,
   10 + 50 iterations, finite |u| < 2, the pressure residual beside phase
   5's; (c) init-channel, initialize_flow on the 1024x512 f32 channel of
   phase 17, its time, the inlet column's mass flow, the card against
   the CPU; (d) channel-128x64, solve_channel_flow at 128x64 f64 with
   default numerics (MULTIGRID, the geometric hierarchy), 100
   iterations, its validation passed;
23. the CLI (orc_tpu_torch.cli.main in this process, so no interpreter
   start and no kernel rebuild), at most 90 s by its own clock: (a)
   every examples/*.toml at its own mesh size, [case] iterations and
   iterations_per_level capped at 20 and [time] steps at 2, outputs
   moved into build/chip_smoke/cli/, each with a checkpoint and
   --history (couette_flow also --vtk): every file read back, the
   fields finite, the velocity-inlet channel's and the couette's u_mean
   of the right sign and within a factor 10 of 1e-3 and of the
   analytical 1.0833e-3, the periodic channels' positive; (b) couette_flow
   and turbulent_channel resumed from those checkpoints (k, eps, mu_t
   too): the first u-momentum residual nearer the first run's last one
   than its first one; (c) cavity.toml's numerics on a 256^2 TGRID
   cavity with relabelled cells: the C++ reader built, timed against
   the Python parser (the same RawMesh) and read_mesh(native=True) (RCM
   order, slice plan); `run` with data, checkpoint and VTK, the data
   rows and the VTK cells equal to the checkpoint mapped through
   to_raw_order, rows 7 and 10 launched, `info` on the file; (d)
   cli-1M, cavity.toml's numerics at 1024^2 (float64: case files carry
   no dtype), 10 then 50 iterations with --history and a checkpoint,
   the solver's median ms/iter over the CLI's chunks of 10 at most 10%
   above the median over the same solve_steady's chunks in this process
   (CLI_TURNS runs of each in turns), the seconds of the CLI's
   save_checkpoint, a profile window; (e) the `bench` subcommand at
   BENCH_ITERS=50 with the extended lines at BENCH_EXT_N=1024: the seven
   lines in orc_tpu's order, finite and positive, the headline last, no
   "extended metrics failed" on stderr; line 1's time per step within
   20% of phase 3's card time of the same shift SpMV instance, and
   lines 3 and 4's no lower than the sum of phase 3's card times of the
   momentum and p' kernels of the same instances;
   (f) `run --device cuda` against `run --device cpu` on a 16^2
   cavity.toml and on the relabelled 16^2 TGRID cavity, checkpoints
   within 1e-9 of scale with equal inner counts;
24. the sharded runtime (orc_tpu_torch/parallel), several partitions on
   the one card (`devices=[card] * P`): (a) run after phase 3b, small
   float64 slices at 2, 3 and 4 partitions, slab and RCB: the parity,
   reference-default and SIMPLE_FC 16^2 cavities (the parity and FC ones
   over 3 slabs too, whose windows start and end inside rows, each
   assembly kernel launched once per partition per iteration), the
   transient 16^2 cavity, geometric and algebraic MULTIGRID (16^2 box,
   permuted 16^2 cavity), the 16x12 RANS channel: each within 1e-8 of the single-
   device run on the card and within 1e-9 of the same sharded run on the
   CPU with equal inner counts, then `run --devices 2` through the CLI,
   cut to the one visible card; (b) refdef-1M (phase 11's numerics) over
   4 slabs, 10 + 30 iterations; (c) fc-cavity-1M (phase 7's) over 4
   slabs, 10 + 30; (d) cavity3d-128 under MULTIGRID (phase 15's) over 4
   slabs, 5 + 10: each with the assembly kernels once per partition per
   iteration (rows 3 and 5 in their streamed-gradient instances, rows 4
   and 6 on the FC path), no fused sweep, finite |u| < 2, the median
   pressure residual within twice the single-device phase's over the
   same iterations, ms/iter, launches and busy share beside it;
phases 4-7 and 9-22 end with a short window under torch.profiler
(device time by kernel, device busy share, launches per iteration), and
each phase that runs the Jacobi sweeps prints the instances it took;
then one JSON line with every kernel's launches, error, card times and
bound, the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.

Kernel launch counters are set to 0 just before each of phases 4-24d and
read just after it, and no plain version of rows 1 and 2 may run on the
card meanwhile, nor row 13's under settings the kernel takes: each phase
must launch every kernel of its path,
the SIMPLE_FC phases none of the parity assembly kernels, the
structured phases no slice-plan kernel, the irregular phases none of
the structured kernels, only the DF32_IR phase the exact slice product,
only phases 13-14 the transient instances of the momentum kernels, only
phase 20 the per-row branches, only phase 15 the z-march of the Jacobi
sweeps, only phases 21b-e row 13 (once per iteration), only phase 22a the slice SpMV on plans built without the gather
table (the multigrid's coarse levels), and phases 17-18 no assembly
kernel, and phase 23 must launch rows 1, 2, 3, 5, 7 and 10 and not the
exact slice product; phases 24b-d launch their assembly kernels once per
partition per iteration and no Jacobi-sweep kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

ANALYTICAL_U_MEAN = 5e-4 / 2 + 1e-3**2 / (12 * 0.001) * 10.0  # 1.0833e-3
#: u_mean of orc_tpu's SIMPLE_FC couette 128x64 f64 with the same
#: settings after 600 iterations (JAX on CPU, f64); recomputed from
#: orc_tpu by tests/test_torch_fc.py::test_fc_couette_reference_u_mean.
#: The implicitly relaxed FC loop develops the channel flow slowly:
#: orc_tpu itself is 48% short of the analytical value there, 24% at
#: 1200 and 17% at 1500.
ORC_TPU_FC_COUETTE_U_MEAN_600 = 5.663693306183816e-4
#: The streamwise-mean u profile (bottom wall to top) of orc_tpu's
#: SIMPLE_FC Re_tau = 590 channel, 4 x 16 f64, after 800 RANS
#: iterations (JAX on CPU, f64; implicit relaxation 0.6 / 0.3);
#: recomputed from orc_tpu by
#: tests/test_torch_turbulence.py::test_re_tau_fc_reference_profile.
ORC_TPU_RE_TAU_FC_U_PROFILE_800 = (
    14.272714873867166, 16.947675032256356, 18.433327362277186,
    19.44600314915601, 20.179983945244622, 20.704377598498166,
    21.041746101858436, 21.204168872236323, 21.204168872236323,
    21.04174610185844, 20.704377598498155, 20.179983945244615,
    19.446003149156002, 18.433327362277183, 16.947675032256353,
    14.272714873867166,
)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
#: Peak rates outside the tensor cores (H100 SXM data sheet): float32
#: 67 TFLOP/s, float64 34 TFLOP/s.
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
ASM_OUT = ("diag", "off", "b")  # the assembly kernels' outputs


_T0 = time.perf_counter()


def log(*args):
    """print, flushed; a phase's header line ("== ...") ends with the
    seconds since the script started."""
    if args and str(args[0]).startswith("== "):
        args = (*args, f"[{time.perf_counter() - _T0:.1f} s]")
    print(*args, flush=True)


def time_ms(fn, reps=5, inner=10):
    """Median over `reps` of the mean CUDA-event time of `inner` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def card_ms(fn, event_ms, tries=3):
    """Card time per call: calls of fn queued behind a sleeping kernel,
    so that the card runs them back to back whatever the host's dispatch
    time, and CUDA events around them. Unlike time_ms it leaves out the
    host's time between launches, which sets the event time of small
    calls. `event_ms` (time_ms of fn) sizes the batch (about 2 ms of
    host time) and the sleep. If the host has not queued every call
    within half the sleep (fn synchronizes, or fills the launch queue),
    the sleep grows fourfold and the window is taken again; after
    `tries` windows the time stands, marked host-limited in the log."""
    from orc_tpu_torch.utils.profiling import sleep_cycles_per_ms

    calls = max(2, min(20, round(2.0 / event_ms)))
    sleep_ms = 1.0 + 2.0 * event_ms * calls
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms()))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if queued_ms < 0.5 * sleep_ms:
            return start.elapsed_time(end) / calls
        sleep_ms *= 4
    log(
        f"    host-limited: {calls} calls took {queued_ms:.1f} ms to queue "
        f"behind a {sleep_ms / 4:.1f} ms sleep"
    )
    return start.elapsed_time(end) / calls


def max_err(got, ref):
    """(max abs error, [max error / max |ref| of each output]). Each
    output is held to its own scale, so a small output (pressure
    coefficients beside face fluxes) cannot hide behind a large one."""
    got, ref = (tuple(t) if isinstance(t, tuple) else (t,) for t in (got, ref))
    abs_errs, rels = [], []
    for g, r in zip(got, ref):
        e = float((g.double() - r.double()).abs().max())
        scale = float(r.double().abs().max())
        abs_errs.append(e)
        rels.append(e / scale if scale else e)
    return max(abs_errs), rels


class Kernel:
    """Results of one kernel's comparisons for the JSON summary. `counter`
    names the wrapper's launch count of this kernel (the momentum
    kernels' transient instances count apart, in `transient_launches`)."""

    def __init__(self, name, fn, source, replaces, counter="launches"):
        self.name, self.fn, self.source, self.replaces = name, fn, source, replaces
        self.counter = counter
        self.max_abs_err = 0.0
        self.ms = self.plain_ms = self.bound_ms = self.library_ms = None
        self.bound_by = "bytes"
        self.card = {}  # label -> the kernel's card ms of that comparison

    def compare(self, label, kernel_call, plain_call, dtype, nbytes, timed,
                outputs=("y",), nops=0, library_call=None, exact=False):
        """Hold the kernel against its plain version, each of `outputs`
        at TOL[dtype] of its own largest |ref| (bitwise when `exact`),
        then time both and, when given, the one PyTorch call computing
        the same function: per call with CUDA events (host dispatch
        included) and on the card alone (card_ms). The summary keeps
        the card times of the `timed` comparison; `card[label]` keeps
        the kernel's card time of every comparison. The bound is the
        larger of `nbytes` over the HBM rate and `nops` over the peak
        rate of the dtype."""
        got, ref = kernel_call(), plain_call()
        torch.cuda.synchronize()
        abs_e, rels = max_err(got, ref)
        if len(rels) != len(outputs):
            raise AssertionError(f"{self.name}: {len(rels)} outputs, expected {outputs}")
        self.max_abs_err = max(self.max_abs_err, abs_e)
        ms, plain_ms = time_ms(kernel_call), time_ms(plain_call)
        lib_ms = None if library_call is None else time_ms(library_call)
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * nops / PEAK_FLOPS[dtype]
        bound_ms = max(t_bytes, t_ops)
        lib = "" if lib_ms is None else f"  library {lib_ms:.4f} ms"
        c_ms, c_plain = card_ms(kernel_call, ms), card_ms(plain_call, plain_ms)
        c_lib = None if library_call is None else card_ms(library_call, lib_ms)
        self.card[label] = c_ms
        if timed:
            self.ms, self.plain_ms, self.library_ms = c_ms, c_plain, c_lib
            self.bound_ms = bound_ms
            self.bound_by = "bytes" if t_bytes >= t_ops else "operations"
        card = (
            f"\n{'':57s}card: kernel {c_ms:.4f} ms  plain {c_plain:.4f} ms"
            + ("" if c_lib is None else f"  library {c_lib:.4f} ms")
            + f"  ({100 * nbytes / c_ms / 1e-3 / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s)"
        )
        per_output = " ".join(f"{o}={r:.2e}" for o, r in zip(outputs, rels))
        log(
            f"  {self.name:20s} {label:34s} max_abs_err={abs_e:.3e} "
            f"err/scale {per_output} (tol {'exact' if exact else f'{TOL[dtype]:.0e}'})  events: kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms{lib}  bound {bound_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB)  {nbytes / ms / 1e6:.0f} GB/s "
            f"({100 * nbytes / ms / 1e-3 / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s){card}"
        )
        tol = 0.0 if exact else TOL[dtype]
        if not all(r <= tol for r in rels):  # NaN fails too
            raise AssertionError(
                f"{self.name} {label}: kernel disagrees with its plain "
                f"version ({per_output}; tol {tol:.0e})"
            )

    def summary(self, launches):
        return dict(
            name=self.name, route="cuda", source=self.source,
            replaces=self.replaces, launches=launches,
            max_abs_err=self.max_abs_err, ms=self.ms, plain_ms=self.plain_ms,
            bound_ms=self.bound_ms, bound_by=self.bound_by,
            library_ms=self.library_ms,
        )


def csr_call(diag, rows, cols, vals, x):
    """The library yardstick of an SpMV: one torch.sparse CSR matrix
    (diagonal + the given entries) times x, built once on the card."""
    C = diag.shape[0]
    idx = torch.arange(C, device=diag.device)
    A = torch.sparse_coo_tensor(
        torch.stack([torch.cat([idx, rows]), torch.cat([idx, cols])]),
        torch.cat([diag, vals]), (C, C),
    ).coalesce().to_sparse_csr()
    xt = x if x.ndim == 1 else x.T.contiguous()
    return lambda: A @ xt


def shift_csr_call(diag, cols, offsets, x):
    """csr_call of a structured matrix in split-column form."""
    C = diag.shape[0]
    i = torch.arange(C, device=diag.device)
    rows, nbrs, vals = [], [], []
    for col, d in zip(cols, offsets):
        ok = ((i + d) >= 0) & ((i + d) < C)
        rows.append(i[ok])
        nbrs.append(i[ok] + d)
        vals.append(col[ok])
    return csr_call(diag, torch.cat(rows), torch.cat(nbrs), torch.cat(vals), x)


def plan_csr_call(diag, coef, plan, x):
    """csr_call of a slice-plan matrix: the nonzero coefficients of each
    tile's used columns [ntiles, n_max, T] (shared by the batch), each at
    its row and the column its slice reads."""
    t, j, lane = coef.nonzero().unbind(1)
    rows = t * plan.tile + lane
    cols = plan.starts.long()[t, j] - plan.pad_lo + lane
    keep = (
        (j < plan.tile_nj.long()[t]) & (rows < plan.n_cells)
        & (cols >= 0) & (cols < plan.n_cells)
    )
    return csr_call(diag, rows[keep], cols[keep], coef[t, j, lane][keep], x)


def structured_system(C, offsets, B, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    off = rng.uniform(-1.0, 0.0, size=(C, len(offsets)))
    c = np.arange(C)
    for k, d in enumerate(offsets):
        off[((c + d) < 0) | ((c + d) >= C), k] = 0.0
    diag = 1.0 + np.abs(off).sum(axis=1) + rng.random(C)
    shape = (B, C) if B > 1 else (C,)
    arrays = (diag, off, rng.standard_normal(shape))
    return [torch.tensor(a, dtype=dtype, device=dev) for a in arrays]


def phase_device():
    log("== phase 1: device")
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: chip_smoke.py needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"device: {torch.cuda.get_device_name(0)}")
    log(smi)
    log(
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    return dev


def phase_build():
    log("== phase 2: build")
    from orc_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    nvcc_s = _cuda.build() if _cuda.is_stale() else 0.0
    _cuda.library()
    log(
        f"kernels built into {_cuda.LIB_PATH} (nvcc {nvcc_s:.1f} s, "
        f"total {time.perf_counter() - t0:.1f} s)"
    )
    if _cuda.PTXAS_LOG.exists():
        for name, regs, spills in ptxas_report(_cuda.PTXAS_LOG.read_text()):
            log(f"  ptxas {name}: {regs} registers, spill stores/loads {spills}")


def demangle(name):
    """A kernel's C++ name without its parameters, where c++filt exists."""
    cxxfilt = shutil.which("c++filt")
    if not cxxfilt:
        return name
    return subprocess.run(
        [cxxfilt, name], capture_output=True, text=True, timeout=60
    ).stdout.strip().split("(")[0].replace("void ", "")


def ptxas_report(text):
    """(kernel, registers, "stores/loads" spill bytes) per entry function
    of an nvcc -Xptxas=-v log, names demangled where c++filt exists."""
    out, name, spills = [], None, "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = demangle(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spills))
            name, spills = None, "?"
    return out


def step_inertia(mesh, vel, rho, dt):
    """An implicit-Euler inertia pair at the main path's shapes: rho V/dt
    and, for vel^n, the velocity field shifted by one cell (a field
    apart from vel, of its magnitudes)."""
    return rho * mesh.cell_volume / dt, torch.roll(vel, 1, 0).contiguous()


#: The inertia term reads rho V/dt and vel^n: 16 bytes per cell in f32.
INERTIA_READS = 4


def phase_kernels(dev, kernels, mom_t, march):
    """Phase 3 (the kernels' comparisons at main-path shapes). Returns
    the (C, K) of the instances phase 23e holds bench's lines 1, 3 and 4
    to: {"spmv": line 1's box, "fused": the 1024^2 cavity}."""
    log("== phase 3: kernels against their plain versions, main-path shapes")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.ops.ck_ops import build_ck_geometry
    from orc_tpu_torch.ops.fields import device_bc
    from orc_tpu_torch.ops.fused_smooth import (
        SweepPlan,
        _launch_sweeps,
        fused_jacobi_sweeps,
        sweep_plan,
        sweeps_plain,
    )
    from orc_tpu_torch.ops.shift_spmv import shift_spmv, shift_spmv_plain
    from orc_tpu_torch.ops.spmv import EllMatrix
    from orc_tpu_torch.solver.simple import solve_steady

    spmv, sweeps, mom, pc = kernels
    # Real inputs: the 1024^2 f32 cavity after 5 iterations.
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    settings = default_settings()
    state, _ = solve_steady(
        mesh, table, settings, 1.0, 1e-3, iterations=5, reporting_interval=5,
        verbose=False,
    )
    _zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=dev)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    cols = asm.column_specs(mesh, table)
    flags = asm.pack_flags(ck.interior, ck.mask)
    bcv = asm.bc_value_table(zs, zv)
    vel, p = state.vel.contiguous(), state.p
    md = state.mom_diag[0].contiguous()
    C, K = mesh.n_cells, len(cols)
    f32 = 4
    m_args = (vel, p, bcv, flags, cols, 1.0, 1e-3, settings.momentum_relaxation)
    mom.compare(
        "cavity 1024^2 f32", lambda: asm.momentum_assembly(*m_args),
        lambda: asm.momentum_assembly_plain(*m_args), torch.float32,
        C * (4 * f32 + 4 + (1 + K + 3) * f32), timed=True, outputs=ASM_OUT,
    )
    # The transient cavity (phase 13): dt = 1/1024, lid Courant number 1.
    t_kw = dict(inertia=step_inertia(mesh, vel, 1.0, 1.0 / 1024))
    mom_t.compare(
        "cavity 1024^2 f32 transient", lambda: asm.momentum_assembly(*m_args, **t_kw),
        lambda: asm.momentum_assembly_plain(*m_args, **t_kw), torch.float32,
        C * ((4 + INERTIA_READS) * f32 + 4 + (1 + K + 3) * f32), timed=True,
        outputs=ASM_OUT,
    )
    p_args = (vel, md, bcv, flags, cols, 1.0)
    pc.compare(
        "cavity 1024^2 f32", lambda: asm.pc_assembly(*p_args),
        lambda: asm.pc_assembly_plain(*p_args), torch.float32,
        C * (4 * f32 + 4 + (1 + K + 1) * f32), timed=True, outputs=ASM_OUT,
    )
    # The solvers' operands: Jacobi-preconditioned split-column systems.
    mdiag, moff, b3 = asm.momentum_assembly(*m_args)
    A = EllMatrix(mdiag, moff, None, mesh.neighbor_offsets).split_columns()
    A, inv_d = A.jacobi_preconditioned()
    b3 = (b3 * inv_d).contiguous()
    x3 = vel.T.contiguous()
    # Row 2's bound: the function reads diag, the K columns, b and x0
    # once and writes x once, whatever the number of sweeps.
    Ks = len(A.off)
    log(f"  fused_jacobi_sweeps cavity 1024^2 f32: "
        f"{sweep_plan(A.offsets, C, 6, torch.float32).label()}")
    for B in (3, 1):
        b, x = (b3, x3) if B == 3 else (b3[0], x3[0])
        sweeps.compare(
            f"cavity 1024^2 f32 B={B} 6 sweeps",
            lambda: fused_jacobi_sweeps(A.diag, A.off, A.offsets, b, x, 6, 0.8),
            lambda: sweeps_plain(A.diag, A.off, A.offsets, b, x, 6, 0.8),
            torch.float32, C * ((1 + Ks) * f32 + 3 * B * f32), timed=B == 3,
            outputs=("x",),
        )
    pdiag, poff, _bp = asm.pc_assembly(*p_args)
    P, _ = EllMatrix(pdiag, poff, None, mesh.neighbor_offsets).split_columns().jacobi_preconditioned()
    for B in (1, 3):
        x = x3[0] if B == 1 else x3
        spmv.compare(
            f"cavity 1024^2 f32 B={B} split",
            lambda: shift_spmv(P.diag, P.off, P.offsets, x),
            lambda: shift_spmv_plain(P.diag, P.off, P.offsets, x),
            torch.float32, C * ((1 + len(P.off)) * f32 + 2 * B * f32),
            timed=B == 1, nops=2 * B * C * (1 + len(P.off)),
            library_call=shift_csr_call(P.diag, P.off, P.offsets, x),
        )
    # bench's extended line 1 (bench.spmv_case): the [C,K] form over the
    # box's six offsets, two of them 0; phase 23e holds the line to it.
    from orc_tpu_torch import bench

    box, _, bdiag, boff, bx = bench.spmv_case(1024, dev, np.random.default_rng(0))
    boffsets = box.neighbor_offsets
    Cb, Kb = boff.shape
    spmv.compare(
        BENCH_SPMV_LABEL,
        lambda: shift_spmv(bdiag, boff, boffsets, bx),
        lambda: shift_spmv_plain(bdiag, boff, boffsets, bx),
        torch.float32, bench.spmv_bytes(Cb, Kb), timed=False,
        nops=2 * Cb * (1 + Kb),
    )
    bench_shapes = dict(spmv=(Cb, Kb), fused=(C, K))
    del box, bdiag, boff, bx
    couette_offsets = (-128, -1, 1, 128)
    for B in (1, 3):
        diag, off, x = structured_system(128 * 64, couette_offsets, B, torch.float64, dev)
        cols64 = tuple(off[:, k] for k in range(4))
        spmv.compare(
            f"couette 128x64 f64 B={B} split",
            lambda: shift_spmv(diag, cols64, couette_offsets, x),
            lambda: shift_spmv_plain(diag, cols64, couette_offsets, x),
            torch.float64, 128 * 64 * (5 * 8 + 2 * B * 8), timed=False,
        )
    # Row 2 on the couette's momentum system (f64, B = 3).
    b = structured_system(128 * 64, couette_offsets, 3, torch.float64, dev, seed=1)[2]
    log(f"  fused_jacobi_sweeps couette 128x64 f64: "
        f"{sweep_plan(couette_offsets, 128 * 64, 6, torch.float64).label()}")
    sweeps.compare(
        "couette 128x64 f64 B=3 6 sweeps",
        lambda: fused_jacobi_sweeps(diag, cols64, couette_offsets, b, x, 6, 0.8),
        lambda: sweeps_plain(diag, cols64, couette_offsets, b, x, 6, 0.8),
        torch.float64, 128 * 64 * (5 * 8 + 3 * 3 * 8), timed=False, outputs=("x",),
    )
    del state, A, P, b3, x3
    # The pressure systems of the 128^3 cavity (phase 15): K = 6, split
    # planes; +-16384 lies far beyond the kernel's shared-memory window.
    n3 = 128**3
    box_offsets = (-128 * 128, -128, -1, 1, 128, 128 * 128)
    diag, off, x = structured_system(n3, box_offsets, 1, torch.float32, dev)
    planes = tuple(off.T.contiguous())
    spmv.compare(
        "cavity3d 128^3 f32 K=6 split",
        lambda: shift_spmv(diag, planes, box_offsets, x),
        lambda: shift_spmv_plain(diag, planes, box_offsets, x),
        torch.float32, n3 * (7 * f32 + 2 * f32), timed=False,
        nops=2 * n3 * 7, library_call=shift_csr_call(diag, planes, box_offsets, x),
    )
    # Row 2 on a momentum system of its shape (B = 3): the smoother of
    # phase 15, in the march sweep_plan picks, held bitwise to the
    # per-sweep kernel, which is timed beside it.
    _d, _o, x3d = structured_system(n3, box_offsets, 3, torch.float32, dev)
    b3d = structured_system(n3, box_offsets, 3, torch.float32, dev, seed=1)[2]
    log(f"  fused_jacobi_sweeps cavity3d 128^3 f32: "
        f"{sweep_plan(box_offsets, n3, 6, torch.float32).label()}")
    args3 = (diag, planes, box_offsets, b3d, x3d, 6, 0.8)
    plain3 = lambda: sweeps_plain(*args3)  # noqa: E731
    nbytes3 = n3 * (7 * f32 + 3 * 3 * f32)
    march.compare(
        "cavity3d 128^3 f32 K=6 B=3 6 sweeps", lambda: fused_jacobi_sweeps(*args3),
        plain3, torch.float32, nbytes3, timed=True, outputs=("x",),
    )
    per_sweep3 = lambda: _launch_sweeps(*args3, SweepPlan())  # noqa: E731
    march.compare(
        "cavity3d 128^3 f32 K=6 B=3 per-sweep", per_sweep3, plain3, torch.float32,
        nbytes3, timed=False, outputs=("x",),
    )
    check_bitwise("cavity3d 128^3 f32 K=6 B=3", fused_jacobi_sweeps(*args3), per_sweep3())
    del diag, off, x, planes, _d, _o, x3d, b3d
    # Row 2 at examples/cavity_3d.toml's shape (phase 23a): case files
    # carry no dtype, so its 48^3 box runs in f64, B = 3.
    n48 = 48**3
    offsets48 = (-48 * 48, -48, -1, 1, 48, 48 * 48)
    diag, off, x = structured_system(n48, offsets48, 3, torch.float64, dev)
    b48 = structured_system(n48, offsets48, 3, torch.float64, dev, seed=1)[2]
    args48 = (diag, tuple(off.T.contiguous()), offsets48, b48, x, 6, 0.8)
    log(f"  fused_jacobi_sweeps cavity_3d.toml 48^3 f64: "
        f"{sweep_plan(offsets48, n48, 6, torch.float64).label()}")
    march.compare(
        "cavity_3d.toml 48^3 f64 K=6 B=3 6 sweeps", lambda: fused_jacobi_sweeps(*args48),
        lambda: sweeps_plain(*args48), torch.float64, n48 * (7 * 8 + 3 * 3 * 8),
        timed=False, outputs=("x",),
    )
    del diag, off, x, b48, args48
    return bench_shapes


def check_bitwise(label, got, per_sweep):
    """Raise unless a Jacobi sweeps instance gave the per-sweep kernel's
    bits (each redesign is held to the kernel before it)."""
    torch.cuda.synchronize()
    same = torch.equal(got, per_sweep)
    log(f"  fused_jacobi_sweeps {label}: equal to the per-sweep kernel bit for bit: {same}")
    if not same:
        raise AssertionError(f"fused_jacobi_sweeps {label}: not bitwise equal to the per-sweep kernel")


def ref_default_settings():
    """scripts/bench_cavity.py with ORC_TPU_BENCH_SCHEME=default: the
    reference's default numerics (CD1 + SecondOrder + Rhie-Chow) under
    forced SIMPLE, implicit relaxation 0.7 / 0.1, Jacobi-preconditioned
    BiCGSTAB(50), the 6-sweep momentum smoother."""
    from orc_tpu_torch.models.cavity import default_settings
    from orc_tpu_torch.utils.settings import (
        MomentumScheme,
        PressureInterpolation,
        PressureVelocityCoupling,
        VelocityInterpolation,
    )

    return default_settings().replace(
        momentum=MomentumScheme.CD1,
        pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        pressure_interpolation=PressureInterpolation.SECOND_ORDER,
    )


def phase_parity_branches(dev, mom, pc, mom_t):
    """The parity kernels' Rhie-Chow / SecondOrder / TVD_DC branches and
    their in-kernel Green-Gauss gradient against their plain versions on
    the reference-default 1024^2 f32 cavity after 5 iterations."""
    log("== phase 3: parity assembly branches (RC, SO, TVD_DC, in-kernel GG), cavity 1024^2 f32")
    from orc_tpu_torch.models.cavity import cavity_case
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.ops.ck_ops import (
        build_ck_geometry,
        ck_bc,
        ck_pressure_gradient,
        ck_velocity_gradient,
    )
    from orc_tpu_torch.ops.fields import device_bc
    from orc_tpu_torch.solver.simple import _kernel_asm_spec, solve_steady
    from orc_tpu_torch.utils.settings import tvd_umist

    settings = ref_default_settings()
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    state, _ = solve_steady(
        mesh, table, settings, 1.0, 1e-3, iterations=5, reporting_interval=5,
        verbose=False,
    )
    zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=dev)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    cols, spec = _kernel_asm_spec(mesh, table, settings, ck)
    if not (spec.rc and spec.p_so and spec.gg):
        raise AssertionError(f"the gate gave {spec} for the reference-default numerics")
    flags, bcv = asm.pack_flags(ck.interior, ck.mask), asm.bc_value_table(zs, zv)
    vel, p, md = state.vel.contiguous(), state.p, state.mom_diag[0].contiguous()
    grad_p = ck_pressure_gradient(mesh, ck, bc, p)
    grad_v = ck_velocity_gradient(mesh, ck, bc, vel)
    C, K, f32 = mesh.n_cells, len(cols), 4
    m_args = (vel, p, bcv, flags, cols, 1.0, 1e-3, settings.momentum_relaxation)
    for label, sp in (
        ("cd1+so+rc gg", spec),
        ("tvd_dc+umist+rc gg", spec._replace(scheme="tvd_dc", psi=tvd_umist, p_so=False)),
        ("cd1+so+rc streamed grad p", spec._replace(gg=False)),
    ):
        tvd = sp.scheme == "tvd_dc"
        kw = dict(grad_p=None if sp.gg else grad_p, mom_diag=md,
                  grad_vel=grad_v if tvd else None, spec=sp)
        # vel, p, md (+ grad p streamed, grad vel); diag, K off, 3 b; flags.
        reads = 3 + 1 + 1 + 3 * (not sp.gg) + 9 * tvd
        mom.compare(
            f"cavity 1024^2 f32 {label}",
            lambda: asm.momentum_assembly(*m_args, **kw),
            lambda: asm.momentum_assembly_plain(*m_args, **kw), torch.float32,
            C * (4 + (reads + 1 + K + 3) * f32), timed=False, outputs=ASM_OUT,
        )
        if sp.gg and not tvd:
            t_kw = dict(kw, inertia=step_inertia(mesh, vel, 1.0, 1.0 / 1024))
            mom_t.compare(
                f"cavity 1024^2 f32 {label} transient",
                lambda: asm.momentum_assembly(*m_args, **t_kw),
                lambda: asm.momentum_assembly_plain(*m_args, **t_kw), torch.float32,
                C * (4 + (reads + INERTIA_READS + 1 + K + 3) * f32), timed=False,
                outputs=ASM_OUT,
            )
    p_args = (vel, md, bcv, flags, cols, 1.0)
    for gg in (True, False):
        kw = dict(p=p, grad_p=None if gg else grad_p, spec=spec._replace(gg=gg))
        pc.compare(
            f"cavity 1024^2 f32 rc {'gg' if gg else 'streamed grad p'}",
            lambda: asm.pc_assembly(*p_args, **kw),
            lambda: asm.pc_assembly_plain(*p_args, **kw), torch.float32,
            C * (4 + (3 + 1 + 1 + 3 * (not gg) + 1 + K + 1) * f32), timed=False,
            outputs=ASM_OUT,
        )
    del state, grad_p, grad_v


def _used_coefs(plan):
    """Coefficients a slice kernel reads: each tile's used columns times
    its rows."""
    dev = plan.tile_nj.device
    t_rows = torch.clamp(
        plan.n_cells - torch.arange(plan.ntiles, device=dev) * plan.tile, max=plan.tile
    )
    return int((plan.tile_nj.long() * t_rows).sum())


def _check_exact(sexact, label, coef, plan, x, timed):
    """Kernel 12 on (coef, x) against its plain version, bitwise, and
    y + err against the f64 product of the hi planes, to 1e-13 of each
    row's sum |coef x|."""
    from orc_tpu_torch.ops.slice_spmv import (
        slice_spmv,
        slice_spmv_exact,
        slice_spmv_exact_plain,
    )

    C, B, used = plan.n_cells, 1 if x.ndim == 1 else x.shape[0], _used_coefs(plan)
    sexact.compare(
        label,
        lambda: slice_spmv_exact(coef, plan, x),
        lambda: slice_spmv_exact_plain(coef, plan, x), torch.float32,
        used * 4 + 3 * B * C * 4 + plan.ntiles * 4 * (1 + plan.n_max),
        timed=timed, nops=11 * B * used, exact=True, outputs=("y", "err"),
    )
    (y, e), (yr, er) = slice_spmv_exact(coef, plan, x), slice_spmv_exact_plain(coef, plan, x)
    if not (torch.equal(y, yr) and torch.equal(e, er)):
        raise AssertionError(f"kernel 12 {label}: (y, err) not bitwise equal to the plain version")
    zero = torch.zeros(C, dtype=torch.float64, device=x.device)
    hi = coef.double()
    ref = slice_spmv(zero, hi, plan, x.double())
    absrow = slice_spmv(zero, hi.abs(), plan, x.double().abs())
    gap = float(((y.double() + e.double() - ref).abs() / absrow.clamp(min=1e-300)).max())
    log(f"  {label}: (y, err) bitwise equal to the plain version; |y + err - f64| / sum|coef x| max {gap:.3e} (limit 1e-13)")
    if not gap <= 1e-13:
        raise AssertionError(f"kernel 12 {label}: y + err off the f64 product by {gap:.3e}")


def phase_exact_kernel(dev, sexact, sspmv):
    """Kernel 12 against its plain version at both plans the DF32_IR
    phase runs it on: the prepared f64 system of the permuted 448^2
    cavity split into f32 planes (what the df32 residual feeds it), B = 1
    and 3, with the native-f64 alternative, the f64 slice SpMV (kernel
    7), timed beside it; and scripts/bench_df32_ir.py's system, whose
    1024-row tiles take more rows than a CTA has threads. On that plan
    kernel 7 is held against its plain version too, at each form phase
    12 (a) runs it in: the f32 inner solves' matrix, the two f32
    cross-term products of the residual (zero diagonal) and the native
    f64 solve's matrix, all Jacobi-preconditioned as the solvers run
    them."""
    log("== phase 3: exact slice product (kernel 12), permuted cavity 448^2 and the bench_df32_ir system")
    from orc_tpu_torch.ops.df32 import df_from_f64
    from orc_tpu_torch.ops.slice_spmv import slice_spmv, slice_spmv_plain
    from orc_tpu_torch.ops.spmv import EllMatrix

    mesh = permuted_cavity(448, torch.float64, dev)[0]
    plan = mesh.slice_plan
    log(f"  {mesh.n_cells} cells; {plan_line(mesh)}")
    C = mesh.n_cells
    interior = _interior(mesh)
    K = interior.shape[1]
    rng = np.random.default_rng(0)
    off = -torch.tensor(rng.uniform(0.0, 1.0, (C, K)), device=dev) * interior
    diag = 1.0 + off.abs().sum(dim=1) + torch.tensor(rng.random(C), device=dev)
    A = EllMatrix(diag, off, mesh.cell_neighbors, plan=plan).prepare()
    coef, _ = df_from_f64(A.off)
    used = _used_coefs(plan)
    out = {}
    for B in (1, 3):
        x64 = torch.tensor(rng.standard_normal((B, C) if B > 1 else C), device=dev)
        _check_exact(sexact, f"permuted cavity 448^2 B={B}", coef, plan, df_from_f64(x64)[0], B == 1)
        if B == 1:
            f64_call = lambda: slice_spmv(A.diag, A.off, plan, x64)  # noqa: E731
            ev = time_ms(f64_call)
            out["f64_spmv_ms"] = card_ms(f64_call, ev)
            log(
                f"  native f64 residual (kernel 7 in f64, same plan): events {ev:.4f} ms, "
                f"card {out['f64_spmv_ms']:.4f} ms; bound "
                f"{1e3 * (used * 8 + 3 * C * 8) / HBM_BYTES_PER_S:.4f} ms"
            )
    del A, coef, mesh

    (m64, _), x_true = _bench_df32_system(dev)
    A = m64[0].prepare()
    plan, C = A.plan, A.plan.n_cells
    used = _used_coefs(plan)
    log(f"  bench_df32_ir system: {C} cells; plan: tile {plan.tile}, ntiles {plan.ntiles}, n_max {plan.n_max}, mean tile_nj {float(plan.tile_nj.double().mean()):.2f}")
    P64, _ = A.jacobi_preconditioned()
    hi, lo = df_from_f64(A.off)
    x64 = torch.tensor(x_true, device=dev)
    xh, xl = df_from_f64(x64)
    _check_exact(sexact, "bench_df32_ir system B=1", hi, plan, xh, False)
    P32, _ = EllMatrix(
        df_from_f64(A.diag)[0], hi, A.neighbors, plan=plan, slice_layout=True
    ).jacobi_preconditioned()
    zero = torch.zeros(C, dtype=torch.float32, device=dev)
    for label, d, c, x in (
        ("f32 inner solve", P32.diag, P32.off, xh),
        ("f32 hi*lo cross term", zero, hi, xl),
        ("f32 lo*hi cross term", zero, lo, xh),
        ("f64 native solve", P64.diag, P64.off, x64),
    ):
        sz = x.dtype.itemsize
        sspmv.compare(
            f"bench_df32_ir {label}",
            lambda: slice_spmv(d, c, plan, x), lambda: slice_spmv_plain(d, c, plan, x),
            x.dtype, used * sz + 3 * C * sz + plan.ntiles * 4 * (1 + plan.n_max),
            timed=False, nops=2 * (used + C),
            library_call=plan_csr_call(d, c, plan, x),
        )
    del A, P64, P32, hi, lo
    return out


def _fc_kernel_inputs(mesh, table, settings, state):
    """The SIMPLE_FC kernels' operands on the main path: the gate's
    (cols, spec), the state's fields and stored flux, flags, BC values
    and the iteration-start gradients."""
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.ops.ck_ops import (
        build_ck_geometry,
        ck_bc,
        ck_pressure_gradient,
        ck_velocity_gradient,
    )
    from orc_tpu_torch.ops.fields import device_bc
    from orc_tpu_torch.solver.simple import _kernel_asm_spec

    zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=mesh.device)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    cols, spec = _kernel_asm_spec(mesh, table, settings, ck, fc=True)
    return dict(
        cols=cols, spec=spec, flags=asm.pack_flags(ck.interior, ck.mask),
        bcv=asm.bc_value_table(zs, zv), vel=state.vel.contiguous(), p=state.p,
        flux=state.flux, md=state.mom_diag[0].contiguous(),
        grad_p=ck_pressure_gradient(mesh, ck, bc, state.p),
        grad_vel=ck_velocity_gradient(mesh, ck, bc, state.vel),
    )


def phase_fc_kernels(dev, fc_mom, fc_pc, fc_mom_t):
    log("== phase 3: SIMPLE_FC assembly kernels against their plain versions")
    from orc_tpu_torch.models.cavity import cavity_case, flagship_settings
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.solver.simple import solve_steady

    cases = [
        ("cavity 1024^2 f32 tvd_dc+umist+rc", torch.float32, True,
         lambda: cavity_case(n=1024, dtype=torch.float32, device=dev),
         flagship_settings(), 1.0, 1e-3),
        ("couette 128x64 f64 cd1+so+rc", torch.float64, False,
         lambda: couette_mesh(dev), fc_couette_settings(), 1000.0, 0.001),
    ]
    for label, dtype, timed, make, settings, rho, mu in cases:
        mesh, table = make()
        state, _ = solve_steady(
            mesh, table, settings, rho, mu, iterations=5, reporting_interval=5,
            verbose=False,
        )
        x = _fc_kernel_inputs(mesh, table, settings, state)
        C, K, sz = mesh.n_cells, len(x["cols"]), dtype.itemsize
        spec = x["spec"]
        m_args = (x["vel"], x["p"], x["flux"], x["bcv"], x["flags"], x["cols"],
                  rho, mu, settings.momentum_relaxation)
        m_kw = dict(grad_p=x["grad_p"], grad_vel=x["grad_vel"], spec=spec)
        # vel, p, K flux planes, grad vel / grad p when read; diag, K off, 3 b.
        reads = 3 + 1 + K + 9 * (spec.scheme == "tvd_dc") + 3 * spec.p_so
        fc_mom.compare(
            label, lambda: asm.fc_momentum_assembly(*m_args, **m_kw),
            lambda: asm.fc_momentum_assembly_plain(*m_args, **m_kw), dtype,
            C * (4 + (reads + 1 + K + 3) * sz), timed=timed, outputs=ASM_OUT,
        )
        # The transient FC cavity (phase 14): dt = 1/1024; the couette at
        # the Stokes startup's dt.
        t_kw = dict(m_kw, inertia=step_inertia(
            mesh, x["vel"], rho, 1.0 / 1024 if timed else 0.005
        ))
        fc_mom_t.compare(
            label + " transient", lambda: asm.fc_momentum_assembly(*m_args, **t_kw),
            lambda: asm.fc_momentum_assembly_plain(*m_args, **t_kw), dtype,
            C * (4 + (reads + INERTIA_READS + 1 + K + 3) * sz), timed=timed,
            outputs=ASM_OUT,
        )
        p_args = (x["vel"], x["md"], x["bcv"], x["flags"], x["cols"], rho)
        p_kw = dict(grad_p=x["grad_p"], spec=spec)
        # vel, md, grad p when read; diag, K off, b, K flux_h.
        fc_pc.compare(
            label, lambda: asm.fc_pc_assembly(*p_args, **p_kw),
            lambda: asm.fc_pc_assembly_plain(*p_args, **p_kw), dtype,
            C * (4 + (4 + 3 * spec.rc + 2 + 2 * K) * sz), timed=timed,
            outputs=ASM_OUT + ("flux_h",),
        )
        del state, x


def fm_bytes(mesh, settings):
    """Bytes of the face-major momentum kernel, each input read once and
    each output written once: the [C,K] slot tables (cell_faces,
    cell_neighbors, sign, mask, the diffusion's off-diagonals), the cell
    arrays (vel, p, grad vel under TVD_DC, the diffusion's diagonal and
    b), the face arrays (flux, area, interior, zone slot, normal, r_on
    under TVD_DC, lw under LINEAR_WEIGHTED) and the outputs (diag, K off
    planes, b, pe)."""
    from orc_tpu_torch.utils.settings import MomentumScheme, PressureInterpolation

    C, K = mesh.cell_faces.shape
    F, s = mesh.n_faces, mesh.dtype.itemsize
    tvd = settings.momentum == MomentumScheme.TVD_DC
    lw = settings.pressure_interpolation == PressureInterpolation.LINEAR_WEIGHTED
    slots = K * (4 + 4 + s + 1 + s)
    cells = (3 + 1 + 9 * tvd + 1 + 3) * s
    faces = (1 + 1 + 3 + 3 * tvd + lw) * s + 1 + 4
    outputs = (1 + K + 3 + 3) * s
    return C * (slots + cells + outputs) + F * faces


class LastFaceMomentum:
    """Keeps the operands of the last face-major momentum assembly
    (`simple.face_momentum`, which both face-major steps call) while
    installed: `args` and `kw` of the call."""

    def __enter__(self):
        from orc_tpu_torch.solver import simple

        self.real, self.args, self.kw = simple.face_momentum, None, None

        def kept(*a, **k):
            self.args, self.kw = a, k
            return self.real(*a, **k)

        simple.face_momentum = kept
        return self

    def __exit__(self, *exc):
        from orc_tpu_torch.solver import simple

        simple.face_momentum = self.real


def phase_fm_kernels(dev, fm):
    """Phase 3: row 13, the face-major momentum kernel, against
    `fm_momentum_plain` (face_pressure + momentum_system) at the shapes
    of the main paths that launch it, on their own step's operands, kept
    from the second of two face-major iterations: the 1024^2 f32 cavity
    under the flagship numerics (fm-fc-cavity-1M, ghia-3200-fm's; TVD_DC
    + UMIST, LINEAR_WEIGHTED, implicit; the timed comparison), steady and
    with phase 14's inertia; the 1024^2 f32 cavity under solve_cavity's
    (fm-cavity-1M; UD, LINEAR_WEIGHTED); the 216^3 f32 cube under the
    same (fm-auto-216, cube-256-fm's; K = 6); the 128x64 f64 couette
    under CD1 with LINEAR face pressures and explicit relaxation. Each
    output within TOL of its largest value, and two launches give the
    same bits."""
    log("== phase 3: the face-major momentum kernel (row 13) against its plain version")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings, flagship_settings
    from orc_tpu_torch.ops import fm_assembly
    from orc_tpu_torch.solver.simple import solve_steady
    from orc_tpu_torch.utils.settings import NumericalSettings, PressureInterpolation

    f32 = torch.float32
    cases = [
        ("cavity 1024^2 f32 tvd_dc+umist", True,
         lambda: cavity_case(n=1024, dtype=f32, device=dev), flagship_settings(), 1.0, 1e-3),
        ("cavity 1024^2 f32 ud", False,
         lambda: cavity_case(n=1024, dtype=f32, device=dev), default_settings(), 1.0, 1e-3),
        ("cube 216^3 f32 ud", False,
         lambda: cavity_case(n=216, nz=216, dtype=f32, device=dev), default_settings(),
         1.0, 1e-2),
        ("couette 128x64 f64 cd1 linear", False, lambda: couette_mesh(dev),
         NumericalSettings(pressure_interpolation=PressureInterpolation.LINEAR,
                           matrix_solver=_bicgstab_50()), 1000.0, 0.001),
    ]
    for label, timed, make, settings, rho, mu in cases:
        mesh, table = make()
        with LastFaceMomentum() as last:
            solve_steady(
                mesh, table, settings, rho, mu, iterations=2, reporting_interval=2,
                verbose=False, use_ck=False,
            )
        args, dtype = last.args[:8], mesh.dtype  # mesh, fbc, settings, rho, vel, flux, p, diff
        if not fm_assembly.takes(settings, dtype) or settings.momentum_source is not None:
            raise AssertionError(f"row 13 {label}: the kernel does not take these settings")
        grad_vel, grad_p = last.kw["grad_vel"], last.kw["grad_p"]
        inertias = [("", None, 0)]
        if timed:  # the transient flagship cavity (phase 14's dt)
            inertias.append(
                (" transient", step_inertia(mesh, args[4], rho, 1.0 / 1024), INERTIA_READS)
            )
        for suffix, inertia, extra_reads in inertias:
            def kernel(inertia=inertia):
                A, b, pe = fm_assembly.fm_momentum_assembly(
                    *args, grad_vel=grad_vel, inertia=inertia
                )
                return A.diag, A.off, b, pe

            def plain(inertia=inertia):
                A, b, pe = fm_assembly.fm_momentum_plain(
                    *args, grad_vel=grad_vel, inertia=inertia, grad_p=grad_p
                )
                return A.diag, A.off, b, pe

            fm.compare(
                label + suffix, kernel, plain, dtype,
                fm_bytes(mesh, settings) + mesh.n_cells * extra_reads * dtype.itemsize,
                timed=timed and not suffix, outputs=("diag", "off", "b", "pe"),
            )
            first, second = kernel(), kernel()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(first, second))
            log(f"  fm_momentum_assembly {label + suffix}: two launches bitwise equal: {same}")
            if not same:
                raise AssertionError(f"row 13 {label + suffix}: two launches gave other bits")
            del first, second
        del mesh, table, last, args, grad_vel, grad_p, inertias


def couette_mesh(dev):
    """bench.py's couette channel, 128x64x1 float64, on `dev`."""
    from orc_tpu_torch.mesh.generate import structured_box_mesh
    from orc_tpu_torch.mesh.zones import FaceCondition

    mesh, table = structured_box_mesh(
        128, 64, 1, lengths=(0.002, 0.001, 0.0001), dtype=torch.float64,
        device=dev,
    )
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(5e-4, 0.0, 0.0))
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.PRESSURE_INLET, scalar_value=0.02)
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


def _bicgstab_50():
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        PreconditionMethod,
        SolutionMethod,
    )

    return MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB, iterations=50,
        preconditioner=PreconditionMethod.JACOBI,
    )


def fc_couette_settings():
    """scripts/gen_residual_fixture.py build(fc_envelope=True): AUTO
    (-> SIMPLE_FC), CD1 + SecondOrder + Rhie-Chow, implicit relaxation
    0.7 / 0.3, BiCGSTAB(50) Jacobi."""
    from orc_tpu_torch.utils.settings import NumericalSettings, RelaxationMode

    return NumericalSettings(
        matrix_solver=_bicgstab_50(),
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
        pressure_relaxation=0.3,
    )


def phase_small_reference(dev):
    """The slice on the card against the same slice on the CPU (plain
    versions) on a 16^2 float64 cavity, with solve_cavity's numerics and
    with the reference's default numerics under forced SIMPLE (the
    parity kernels' Rhie-Chow + SecondOrder branch, in-kernel GG): equal
    inner iteration counts and fields to 1e-9 of their scale."""
    from orc_tpu_torch.models.cavity import cavity_case, default_settings
    from orc_tpu_torch.solver.simple import solve_steady, stack_history

    for name, settings in (
        ("solve_cavity", default_settings()), ("reference default", ref_default_settings())
    ):
        log(f"== phase 3b: slice on the card vs on the CPU, cavity 16^2 f64, {name} numerics, 10 iterations")
        out = []
        for d in (dev, torch.device("cpu")):
            mesh, table = cavity_case(n=16, device=d)
            state, hist = solve_steady(
                mesh, table, settings, 1.0, 0.01, iterations=10,
                reporting_interval=10, verbose=False,
            )
            out.append((state, stack_history(hist)))
        (sg, hg), (sc, hc) = out
        np.testing.assert_array_equal(hg.mom_iters, hc.mom_iters)
        np.testing.assert_array_equal(hg.pc_iters, hc.pc_iters)
        for field in ("vel", "p"):
            rel = max_err(getattr(sg, field).cpu(), getattr(sc, field))[1][0]
            log(f"  {field}: max error / scale = {rel:.3e} (tol 1e-9)")
            if not rel <= 1e-9:
                raise AssertionError(f"{name} cuda vs cpu {field} differ by {rel:.3e}")
        log(f"  pc_iters equal: {hg.pc_iters.tolist()}")
    phase_small_reference_fc(dev)


def _flux_divergence(mesh, flux):
    """(max |sum_k flux A|, max |flux A|) over the cells."""
    area = mesh.face_area[mesh.cell_faces.long()]
    fa = torch.where(mesh.cell_face_mask, flux * area, torch.zeros((), dtype=area.dtype, device=area.device))
    return float(fa.sum(dim=1).abs().max()), float(fa.abs().max())


def phase_small_reference_fc(dev):
    """SIMPLE_FC on the card against the CPU, 16^2 float64 cavity with the
    flagship numerics, 10 iterations, with equal inner iteration counts.
    With the pressure solved by Jacobi(50), fields and flux to 1e-9 of
    scale. With the flagship's own BiCGSTAB(50), which amplifies one-ulp
    differences on the full-p system (ROADMAP Queue 3), to 1e-6 of
    scale (measured 2.8e-8, flux, on the H100). Then the twin of orc_tpu's
    test_fc_flux_conservation_every_iteration on the card: three
    iterations into the 12^2 cavity, max |sum_k flux A| < 1e-3
    max |flux A| (div(flux) is the pressure solve's residual)."""
    log("== phase 3b: SIMPLE_FC on the card vs on the CPU, cavity 16^2 f64, 10 iterations")
    from orc_tpu_torch.models.cavity import cavity_case, flagship_settings
    from orc_tpu_torch.solver.simple import solve_steady, stack_history
    from orc_tpu_torch.utils.settings import MatrixSolverSettings, SolutionMethod

    jacobi = MatrixSolverSettings(solver_type=SolutionMethod.JACOBI, iterations=50)
    for solver in ("jacobi", "bicgstab"):
        settings = flagship_settings()
        if solver == "jacobi":
            settings = settings.replace(matrix_solver=jacobi)
        out = []
        for d in (dev, torch.device("cpu")):
            mesh, table = cavity_case(n=16, device=d)
            state, hist = solve_steady(
                mesh, table, settings, 1.0, 1e-3, iterations=10,
                reporting_interval=10, verbose=False,
            )
            div, scale = _flux_divergence(mesh, state.flux)
            log(f"  {solver} {d.type}: max |div flux| / max |flux A| = {div / scale:.3e}")
            out.append((state, stack_history(hist)))
        (sg, hg), (sc, hc) = out
        errs = {n: max_err(getattr(sg, n).cpu(), getattr(sc, n))[1][0] for n in ("vel", "p", "flux")}
        same_iters = bool(
            np.array_equal(hg.mom_iters, hc.mom_iters)
            and np.array_equal(hg.pc_iters, hc.pc_iters)
        )
        log(
            f"  {solver}: error / scale vel {errs['vel']:.3e} p {errs['p']:.3e} "
            f"flux {errs['flux']:.3e} (tol {1e-9 if solver == 'jacobi' else 1e-6:.0e}); pc_iters card {hg.pc_iters.tolist()} "
            f"cpu {hc.pc_iters.tolist()}"
        )
        if not same_iters:
            raise AssertionError(f"SIMPLE_FC {solver} cuda vs cpu: inner iteration counts differ")
        tol = 1e-9 if solver == "jacobi" else 1e-6
        for n, e in errs.items():
            if not e <= tol:
                raise AssertionError(f"SIMPLE_FC {solver} cuda vs cpu {n} differ by {e:.3e} (tol {tol:.0e})")
    from orc_tpu_torch.utils.settings import (
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        PressureVelocityCoupling,
        RelaxationMode,
    )

    mesh, table = cavity_case(n=12, device=dev)
    twin = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE_FC,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        relaxation_mode=RelaxationMode.IMPLICIT,
        momentum_relaxation=0.7,
        pressure_relaxation=0.3,
        matrix_solver=_bicgstab_50(),
    )
    state, _ = solve_steady(
        mesh, table, twin, 1.0, 0.01, iterations=3, reporting_interval=3,
        verbose=False,
    )
    div, scale = _flux_divergence(mesh, state.flux)
    log(f"  conservation, cavity 12^2, 3 iterations: max |div flux| / max |flux A| = {div / scale:.3e} (limit 1e-3)")
    if not div < 1e-3 * scale:
        raise AssertionError("SIMPLE_FC flux not conservative on the card")


def _card_cpu_gap(name, out, tol, fields=("vel", "p")):
    """Hold a card run against its CPU twin: equal inner iteration
    counts, each field to `tol` of its scale."""
    (sg, hg), (sc, hc) = out
    errs = {n: max_err(getattr(sg, n).cpu(), getattr(sc, n))[1][0] for n in fields}
    counts = [
        np.asarray(torch.as_tensor(getattr(h, f)).cpu())
        for f in ("mom_iters", "pc_iters") for h in (hg, hc)
    ]
    same = all(np.array_equal(a, b) for a, b in zip(counts[::2], counts[1::2]))
    log(
        f"  {name}: error / scale "
        + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {tol:.0e}); inner counts equal: {same}"
    )
    if not same:
        raise AssertionError(f"{name} cuda vs cpu: inner iteration counts differ")
    for n, e in errs.items():
        if not e <= tol:
            raise AssertionError(f"{name} cuda vs cpu {n} differ by {e:.3e} (tol {tol:.0e})")


def mg_settings(levels=3, smoother=5):
    """Jacobi-preconditioned geometric MULTIGRID, BiCGSTAB smoothing."""
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        PreconditionMethod,
        SolutionMethod,
    )

    return MatrixSolverSettings(
        solver_type=SolutionMethod.MULTIGRID, iterations=40 if levels == 3 else 50,
        multigrid_levels=levels, multigrid_smoother_iterations=smoother,
        preconditioner=PreconditionMethod.JACOBI,
    )


def phase_small_reference_transient(dev):
    """The transient slice and MULTIGRID on the card against the CPU, 16^2
    float64 cavity: solve_transient (3 steps x 4 inner iterations, dt
    0.05) with solve_cavity's numerics under SIMPLE (BiCGSTAB(50)
    pressure) and under SIMPLE_FC (Jacobi(50) pressure, as the steady FC
    check), and solve_steady under MULTIGRID (tests/test_gmg.py's cavity
    settings, 10 iterations): equal inner counts, fields to 1e-9 of
    scale."""
    log("== phase 3b: transient and MULTIGRID slices on the card vs on the CPU, cavity 16^2 f64")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings
    from orc_tpu_torch.solver.simple import solve_steady, stack_history
    from orc_tpu_torch.solver.transient import solve_transient
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        PressureVelocityCoupling,
        SolutionMethod,
    )

    jacobi = MatrixSolverSettings(solver_type=SolutionMethod.JACOBI, iterations=50)
    for name, settings in (
        ("transient SIMPLE", default_settings().replace(
            pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE)),
        ("transient SIMPLE_FC", default_settings().replace(
            pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE_FC,
            matrix_solver=jacobi)),
    ):
        out = []
        for d in (dev, torch.device("cpu")):
            mesh, table = cavity_case(n=16, device=d)
            out.append(solve_transient(
                mesh, table, settings, 1.0, 0.01, dt=0.05, n_steps=3,
                inner_iterations=4, verbose=False,
            ))
        _card_cpu_gap(name, out, 1e-9, ("vel", "p", "flux") if "FC" in name else ("vel", "p"))
    out = []
    for d in (dev, torch.device("cpu")):
        mesh, table = cavity_case(n=16, device=d)
        state, hist = solve_steady(
            mesh, table, default_settings().replace(matrix_solver=mg_settings()),
            1.0, 0.01, iterations=10, reporting_interval=10, verbose=False,
        )
        out.append((state, stack_history(hist)))
    _card_cpu_gap("steady MULTIGRID", out, 1e-9)


def _timed_transient(mesh, table, settings, rho, mu, dt, steps, inner, state=None):
    from orc_tpu_torch.solver.transient import solve_transient

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = solve_transient(
        mesh, table, settings, rho, mu, dt=dt, n_steps=steps,
        inner_iterations=inner, state=state, verbose=False,
    )
    torch.cuda.synchronize()
    return state, metrics, time.perf_counter() - t0


def phase_transient_cavity(dev, fc=False):
    """The lid-driven cavity 1024^2 f32 at Re = 1000 marched from rest with
    dt = 1/1024 (lid Courant number 1): solve_cavity's numerics (parity
    SIMPLE, 10 steps x 10 inner iterations) or the Ghia flagship's
    (SIMPLE_FC, implicit 0.6 / 0.03, 5 x 10). Reports ms per inner
    iteration, the cell Courant numbers, then a profile window of one
    step of 3 inner iterations; finite |u| < 2."""
    from orc_tpu_torch.models.cavity import (
        cavity_case,
        default_settings,
        flagship_settings,
    )
    from orc_tpu_torch.solver.transient import courant_numbers

    if fc:
        log("== phase 14: transient SIMPLE_FC cavity 1024^2 f32, Ghia flagship numerics, Re=1000, dt=1/1024")
        settings, steps = flagship_settings(), 5
    else:
        log("== phase 13: transient cavity 1024^2 f32, solve_cavity configuration, Re=1000, dt=1/1024")
        settings, steps = default_settings(), 10
    inner, dt = 10, 1.0 / 1024
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    state, metrics, wall = _timed_transient(mesh, table, settings, 1.0, 1e-3, dt, steps, inner)
    n = steps * inner
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.abs(u).max() < 2.0):
        raise AssertionError("transient cavity fields not finite or |u| >= 2")
    co = [float(c) for c in courant_numbers(mesh, table, state.vel, dt)]
    log(
        f"  {steps} steps x {inner} inner iterations {wall:.3f} s -> "
        f"{1e3 * wall / n:.2f} ms per inner iteration; |u| max {np.abs(u).max():.3f}; "
        f"Courant avg/min/max {co[0]:.3f}/{co[1]:.3f}/{co[2]:.3f}; pressure "
        f"iterations {metrics.pc_iters.float().mean().item():.2f} (last of each step)"
    )
    prof = profile_window(
        lambda: _timed_transient(mesh, table, settings, 1.0, 1e-3, dt, 1, 3, state)[2], 3
    )
    return dict(ms_per_iter=1e3 * wall / n, iterations=n + 3, **prof)


#: bench_cavity.py 128 f32 128 100: the 3-D cavity's pressure relaxation.
CAVITY_3D_PRESSURE_RELAXATION = 0.02


def phase_cavity_3d(dev):
    """The 3-D 128^3 cavity f32 at Re = 100 (scripts/bench_cavity.py 128
    f32 128 100: UD + LinearWeighted, forced SIMPLE, implicit 0.7 /
    0.02), 20 iterations from rest under 5-level geometric MULTIGRID
    with 4 smoother iterations (BASELINE.md:79-91), then its
    BiCGSTAB(50) twin: ms/iter, mean pressure iterations (MULTIGRID's
    below the twin's), finite fields; a profile window of 3 MULTIGRID
    iterations."""
    log("== phase 15: 3-D cavity 128^3 f32, Re=100, MULTIGRID (5 levels, 4 smoother iterations) and its BiCGSTAB(50) twin")
    from orc_tpu_torch.models.cavity import cavity_case
    from orc_tpu_torch.solver.gmg import build_mg_hierarchy

    base = bench_irregular_settings().replace(
        pressure_relaxation=CAVITY_3D_PRESSURE_RELAXATION
    )
    t0 = time.perf_counter()
    mesh, table = cavity_case(n=128, nz=128, dtype=torch.float32, device=dev)
    log(f"  {mesh.n_cells} cells, K = {len(mesh.neighbor_offsets)}, built in {time.perf_counter() - t0:.1f} s")
    out = {}
    for name, ms in (("MULTIGRID", mg_settings(levels=5, smoother=4)), ("BiCGSTAB(50)", _bicgstab_50())):
        settings = base.replace(matrix_solver=ms)
        if name == "MULTIGRID":
            levels = build_mg_hierarchy(mesh, None, settings)
            log(f"  levels: {[lv.cdims for lv in levels]}")
        state, hist, wall = _timed_solve(mesh, table, settings, 1.0, 1e-2, None, 20, 20)
        h = hist[-1]
        pc = h.pc_iters.float().mean().item()
        u = state.vel.cpu().numpy()
        finite = bool(np.isfinite(u).all() and np.isfinite(state.p.cpu().numpy()).all())
        out[name] = dict(
            ms_per_iter=1e3 * wall / 20, pc_iters=pc, warm=0,
            pc_residual=h.pc_residual.cpu().numpy(),
        )
        log(
            f"  {name}: 20 iterations {wall:.3f} s -> {1e3 * wall / 20:.2f} ms/iter; mean "
            f"pressure iterations {pc:.2f}; p_corr_norm last {h.p_corr_norm[-1].item():.3e}; "
            f"|u| max {np.abs(u).max():.3f}; finite {finite}"
        )
        if not finite:
            raise AssertionError(f"3-D cavity {name} fields not finite")
        if name == "MULTIGRID":
            out["profile"] = profile(mesh, table, settings, 1.0, 1e-2, state, iterations=3)
        del state
    if not out["MULTIGRID"]["pc_iters"] < out["BiCGSTAB(50)"]["pc_iters"]:
        raise AssertionError("MULTIGRID did not take fewer pressure iterations than BiCGSTAB(50)")
    return out


#: tests/test_transient.py's Taylor-Green run: 32^2 cells, dt 0.05.
TG_TEST_N, TG_TEST_DT = 32, 0.05


def phase_taylor_green(dev):
    """The Taylor-Green vortex on a 256^2 x-y periodic box, f64 (the
    settings of tests/test_transient.py: AUTO -> SIMPLE_FC, CD1 +
    Rhie-Chow, implicit 0.7 / 0.3, BiCGSTAB(50)), 20 steps x 10 inner
    iterations: every velocity component decays as e^(-2 nu t); the
    pointwise error and the kinetic-energy ratio within 5e-3.

    dt keeps the Courant number of the test's 32^2 run (dt 0.05 there).
    At 256^2 with dt 0.05 (Courant ~2) ten inner iterations do not
    converge a step, in orc_tpu as in the port: both end 7.7e-3 above
    the exact kinetic energy (tests/torch_taylor_green_scan.py)."""
    log("== phase 16: Taylor-Green vortex 256^2 f64, 20 steps x 10 inner iterations")
    from orc_tpu_torch.mesh.generate import structured_box_mesh
    from orc_tpu_torch.solver.simple import initial_state
    from orc_tpu_torch.utils.settings import (
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        RelaxationMode,
        VelocityInterpolation,
    )

    N, rho, mu, steps = 256, 1.0, 0.02, 20
    dt = TG_TEST_DT * TG_TEST_N / N
    mesh, table = structured_box_mesh(
        N, N, 1, lengths=(2 * np.pi, 2 * np.pi, 1.0), periodic=("x", "y"),
        dtype=torch.float64, device=dev,
    )
    cc = mesh.cell_centroid.cpu().numpy()
    x, y = cc[:, 0], cc[:, 1]
    u0, v0 = np.sin(x) * np.cos(y), -np.cos(x) * np.sin(y)
    p0 = rho / 4.0 * (np.cos(2 * x) + np.cos(2 * y))
    state = initial_state(mesh, vel=np.stack([u0, v0, 0 * u0], -1), p=p0)
    settings = NumericalSettings(
        momentum=MomentumScheme.CD1,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        pressure_relaxation=0.3,
        momentum_relaxation=0.7,
        relaxation_mode=RelaxationMode.IMPLICIT,
        matrix_solver=_bicgstab_50(),
    )
    state, metrics, wall = _timed_transient(mesh, table, settings, rho, mu, dt, steps, 10, state)
    decay = np.exp(-2 * (mu / rho) * dt * steps)
    u, v = state.vel[:, 0].cpu().numpy(), state.vel[:, 1].cpu().numpy()
    err = max(np.abs(u - u0 * decay).max(), np.abs(v - v0 * decay).max())
    e_ratio = np.sum(u * u + v * v) / (decay**2 * np.sum(u0**2 + v0**2))
    log(
        f"  {steps} steps of dt {dt} x 10 inner iterations {wall:.3f} s -> {1e3 * wall / (10 * steps):.2f} "
        f"ms per inner iteration; max pointwise error {err:.3e}, kinetic-energy ratio "
        f"{e_ratio:.6f} (limits 5e-3); pressure iterations {metrics.pc_iters.float().mean().item():.2f}"
    )
    if not (err < 5e-3 and abs(e_ratio - 1.0) < 5e-3):
        raise AssertionError("the Taylor-Green vortex left the exact decay")
    prof = profile_window(
        lambda: _timed_transient(mesh, table, settings, rho, mu, dt, 1, 3, state)[2], 3
    )
    return dict(ms_per_iter=1e3 * wall / (10 * steps), err=err, e_ratio=e_ratio, **prof)


def _timed_solve(mesh, table, settings, rho, mu, state, iterations, chunk, use_ck="auto"):
    from orc_tpu_torch.solver.simple import solve_steady

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = solve_steady(
        mesh, table, settings, rho, mu, state=state, iterations=iterations,
        reporting_interval=chunk, verbose=False, use_ck=use_ck,
    )
    torch.cuda.synchronize()
    return state, hist, time.perf_counter() - t0


def check_couette_u_mean(u, done):
    err = abs(u.mean() - ANALYTICAL_U_MEAN) / ANALYTICAL_U_MEAN
    log(
        f"  u_mean after {done} iterations {u.mean():.6e} (analytical "
        f"{ANALYTICAL_U_MEAN:.4e}, rel err {err:.3f}, limit 0.25)"
    )
    if not err < 0.25:
        raise AssertionError("couette u_mean drifted from the analytical value")


def phase_couette(dev, fc=False):
    """100 warm-up + `timed` timed iterations (iters/s), then the
    u_mean check: against the analytical profile for the parity run (cut
    to 200 timed iterations to keep the script's run time down), against
    orc_tpu's u_mean after 600 iterations for the SIMPLE_FC run (see
    ORC_TPU_FC_COUETTE_U_MEAN_600)."""
    from orc_tpu_torch.utils.settings import NumericalSettings

    if fc:
        log("== phase 6: SIMPLE_FC couette 128x64x1 f64, FC residual fixture settings")
        settings, timed = fc_couette_settings(), 500
    else:
        log("== phase 4: couette 128x64x1 f64, bench.py configuration")
        settings, timed = NumericalSettings(matrix_solver=_bicgstab_50()), 200
    mesh, table = couette_mesh(dev)
    state, _, warm_s = _timed_solve(mesh, table, settings, 1000.0, 0.001, None, 100, 100)
    state, hist, dt = _timed_solve(mesh, table, settings, 1000.0, 0.001, state, timed, 100)
    pc_it = np.concatenate([h.pc_iters.cpu().numpy() for h in hist])
    mom_it = np.concatenate([h.mom_iters.cpu().numpy() for h in hist])
    log(
        f"  warm-up 100 iterations {warm_s:.2f} s; {timed} timed iterations "
        f"{dt:.3f} s -> {timed / dt:.1f} iters/s ({1e3 * dt / timed:.3f} ms/iter); "
        f"mean inner iterations: momentum "
        f"{mom_it.mean(axis=0).round(2).tolist()}, pressure {pc_it.mean():.2f}"
    )
    done = 100 + timed
    u = state.vel[:, 0].cpu().numpy()
    if not np.isfinite(u).all():
        raise AssertionError("couette produced non-finite fields")
    if fc:
        # The implicitly relaxed FC loop develops the flow slowly
        # (orc_tpu itself is 48% short of the analytical u_mean here):
        # hold the run to orc_tpu's own u_mean after 600 iterations.
        u_ref = ORC_TPU_FC_COUETTE_U_MEAN_600
        rel = abs(u.mean() - u_ref) / u_ref
        log(f"  u_mean after {done} iterations {u.mean():.6e}, orc_tpu {u_ref:.6e} (rel diff {rel:.2e}, limit 1e-6)")
        if not rel < 1e-6:
            raise AssertionError("SIMPLE_FC couette left orc_tpu's trajectory")
    else:
        check_couette_u_mean(u, done)
    profile(mesh, table, settings, 1000.0, 0.001, state, iterations=5)
    return dict(iters_per_s=timed / dt, u_mean=float(u.mean()))


def phase_cavity(dev, fc=False):
    from orc_tpu_torch.models.cavity import (
        cavity_case,
        default_settings,
        flagship_settings,
    )

    if fc:
        log("== phase 7: SIMPLE_FC cavity 1024^2 f32, Ghia flagship numerics, Re=1000")
        settings = flagship_settings()
    else:
        log("== phase 5: cavity 1024^2 f32, solve_cavity configuration, Re=1000")
        settings = default_settings()
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, 1e-3, None, 10, 10)
    before = launch_snapshot()
    state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-3, state, 50, 50)
    structure = launch_structure(before, hist, settings)
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.abs(u).max() < 2.0):
        raise AssertionError("cavity fields not finite or |u| >= 2")
    pc_it = hist[-1].pc_iters.cpu().numpy()
    mom_it = hist[-1].mom_iters.cpu().numpy()
    log(
        f"  warm-up 10 iterations {warm_s:.2f} s; 50 timed iterations "
        f"{dt:.3f} s -> {1e3 * dt / 50:.2f} ms/iter; |u| max {np.abs(u).max():.3f}"
    )
    log(
        f"  mean inner iterations: momentum {mom_it.mean(axis=0).tolist()}, "
        f"pressure {pc_it.mean():.2f}"
    )
    div_ratio = None
    pc_res = float(np.median(np.concatenate([h.pc_residual.cpu().numpy() for h in hist])))
    if fc:
        div, scale = _ck_flux_divergence(mesh, state.flux)
        div_ratio = div / scale
        log(
            f"  max |div flux| / max |flux A| = {div_ratio:.3e} (the last pressure "
            f"solve's residual); median pressure residual {pc_res:.3e}"
        )
    window = profile(mesh, table, settings, 1.0, 1e-3, state, iterations=5)
    return dict(
        ms_per_iter=1e3 * dt / 50, vel_avg=hist[-1].vel_avg[-1].cpu().numpy(),
        structure=structure, div_ratio=div_ratio, pc_residual_median=pc_res,
        pc_residual=np.concatenate([h.pc_residual.cpu().numpy() for h in hist]),
        warm=10, **window,
    )


def phase_sequenced(dev):
    log("== phase 8: solve_steady_sequenced 64^2 -> 128^2 f32, flagship numerics, 100 iterations per level")
    from orc_tpu_torch.models.cavity import cavity_case, flagship_settings
    from orc_tpu_torch.solver.sequencing import solve_steady_sequenced

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hists = solve_steady_sequenced(
        lambda nx, ny, nz: cavity_case(n=nx, dtype=torch.float32, device=dev),
        [(64, 64, 1), (128, 128, 1)], flagship_settings(), 1.0, 1e-3,
        iterations_per_level=100, reporting_interval=100, verbose=False,
    )
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.isfinite(state.p.cpu().numpy()).all()):
        raise AssertionError("sequenced cascade produced non-finite fields")
    log(
        f"  2 levels x 100 iterations {dt:.2f} s; 128^2 |u| max "
        f"{np.abs(u).max():.3f}; final pressure iterations "
        f"{hists[-1][-1].pc_iters[-1].item()}"
    )


def permuted_mesh(box, dtype, dev, seed=0):
    """`box` (a structured mesh on the CPU, float64) with randomly
    permuted cell ids, compiled with compile_from_arrays on `dev`: no
    structured offsets survive, so the mesh is RCM-reordered and gets a
    slice plan (orc_tpu's scripts/bench_irregular.py build_irregular).
    Returns (mesh, perm); cell i of the permuted input is box cell
    perm[i]."""
    from orc_tpu_torch.mesh.compile import compile_from_arrays

    a = lambda t: t.cpu().numpy()  # noqa: E731
    C = box.n_cells
    perm = np.random.default_rng(seed).permutation(C)
    inv = np.empty(C, np.int64)
    inv[perm] = np.arange(C)
    interior = a(box.face_interior)
    mesh = compile_from_arrays(
        dim=box.dim,
        face_owner=inv[a(box.face_owner)],
        face_neighbor=np.where(interior, inv[a(box.face_neighbor)], -1),
        face_area=a(box.face_area),
        face_normal=a(box.face_normal),
        face_centroid=a(box.face_centroid),
        face_zone_slot=a(box.face_zone_slot),
        cell_centroid=a(box.cell_centroid)[perm],
        cell_volume=a(box.cell_volume)[perm],
        dtype=dtype,
        device=dev,
    )
    return mesh, perm


def permuted_tgrid(src, dst, seed=0):
    """Copy the TGRID box `src` (mesh.generate.write_tgrid) to `dst` with
    its cells relabelled by a seeded permutation (old cell i becomes cell
    perm[i]): the file then reads as an irregular mesh, which read_mesh
    RCM-reorders and gives a slice plan. Returns perm."""
    with open(src) as f:
        lines = f.read().split("\n")
    n_cells = next(
        int(line.split()[3], 16) for line in lines if line.startswith("(12 (0 ")
    )
    perm = np.random.default_rng(seed).permutation(n_cells)
    in_faces = False
    for i, line in enumerate(lines):
        if line.startswith("(13 (") and not line.startswith("(13 (0 "):
            in_faces = True
        elif in_faces and line.startswith(")"):
            in_faces = False
        elif in_faces:
            tok = line.split()
            for j in (-2, -1):  # the face's two cells, 0 for none
                c = int(tok[j], 16)
                if c:
                    tok[j] = f"{perm[c - 1] + 1:x}"
            lines[i] = " ".join(tok)
    with open(dst, "w") as f:
        f.write("\n".join(lines))
    return perm


def to_box_order(mesh, perm, field):
    """A compiled-order cell field (numpy) of a permuted mesh in the
    structured box's cell order."""
    raw = np.empty_like(field)
    raw[mesh.cell_order.cpu().numpy()] = field
    out = np.empty_like(raw)
    out[perm] = raw
    return out


@functools.cache
def permuted_cavity(n, dtype, dev, seed=0):
    """(mesh, table, perm) of the permuted n^2 cavity, built once per run:
    phases 3, 9 and 12 share the 448^2 meshes (each build takes seconds
    of host time)."""
    from orc_tpu_torch.models.cavity import cavity_case

    box, table = cavity_case(n=n, device="cpu")
    mesh, perm = permuted_mesh(box, dtype, dev, seed)
    return mesh, table, perm


def plan_line(mesh):
    p = mesh.slice_plan
    nj = p.tile_nj.double()
    return (
        f"plan: tile {p.tile}, ntiles {p.ntiles}, n_max {p.n_max}, mean "
        f"tile_nj {float(nj.mean()):.2f} (max {int(nj.max())}), pad_lo "
        f"{p.pad_lo}, j0 {p.j0}"
    )


def _interior(mesh):
    return mesh.face_interior[mesh.cell_faces.long()] & mesh.cell_face_mask


def phase_slice_kernels(dev, sspmv, snbr):
    """Kernels 7-11 against their plain versions on the permuted 448^2
    cavity (f32, and f64 as the DF32_IR phase's native run takes it),
    the permuted 1024^2 cavity (f32) and the permuted couette 128x64
    (f64): SpMV B = 1 and 3, gather of 1, 3 and 9 fields, on a seeded
    diagonally dominant system over each mesh's own sparsity, Jacobi
    preconditioned and prepared as the solvers run it."""
    log("== phase 3: slice-plan kernels against their plain versions")
    from orc_tpu_torch.ops.slice_spmv import (
        slice_nbr_values,
        slice_nbr_values_plain,
        slice_spmv,
        slice_spmv_plain,
    )
    from orc_tpu_torch.ops.spmv import EllMatrix

    cases = [
        ("permuted cavity 448^2 f32", torch.float32, True,
         lambda: permuted_cavity(448, torch.float32, dev)[0]),
        ("permuted cavity 448^2 f64", torch.float64, False,
         lambda: permuted_cavity(448, torch.float64, dev)[0]),
        ("permuted cavity 1024^2 f32", torch.float32, False,
         lambda: permuted_cavity(1024, torch.float32, dev)[0]),
        ("permuted couette 128x64 f64", torch.float64, False,
         lambda: permuted_mesh(couette_mesh("cpu")[0], torch.float64, dev)[0]),
    ]
    for label, dtype, timed, make in cases:
        t0 = time.perf_counter()
        mesh = make()
        plan = mesh.slice_plan
        log(f"  {label}: {mesh.n_cells} cells, built in {time.perf_counter() - t0:.1f} s; {plan_line(mesh)}")
        C, sz = mesh.n_cells, dtype.itemsize
        interior = _interior(mesh)
        K = interior.shape[1]
        rng = np.random.default_rng(0)
        off = -torch.tensor(rng.uniform(0.0, 1.0, (C, K)), dtype=dtype, device=dev) * interior
        diag = 1.0 + off.abs().sum(dim=1) + torch.tensor(rng.random(C), dtype=dtype, device=dev)
        A = EllMatrix(diag, off, mesh.cell_neighbors, plan=plan).prepare()
        A, _ = A.jacobi_preconditioned()
        nbr = mesh.cell_neighbors.long()
        rows = torch.arange(C, device=dev)[:, None].expand(C, K)[interior]
        lib_vals = (off / diag[:, None])[interior]
        nj = plan.tile_nj.long()
        t_rows = torch.clamp(C - torch.arange(plan.ntiles, device=dev) * plan.tile, max=plan.tile)
        used = int((nj * t_rows).sum())  # coefficients the kernel reads
        for B in (1, 3):
            x = torch.tensor(rng.standard_normal((B, C) if B > 1 else C), dtype=dtype, device=dev)
            sspmv.compare(
                f"{label} B={B}",
                lambda: slice_spmv(A.diag, A.off, plan, x),
                lambda: slice_spmv_plain(A.diag, A.off, plan, x),
                dtype, used * sz + C * sz + 2 * B * C * sz + plan.ntiles * 4 * (1 + plan.n_max),
                timed=timed and B == 1, nops=2 * B * (used + C),
                library_call=csr_call(A.diag, rows, nbr[interior], lib_vals, x),
            )
        n_int = int(interior.sum())
        for F in (1, 3, 9):
            shape = (C,) if F == 1 else (C, 3) if F == 3 else (C, 3, 3)
            xf = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
            snbr.compare(
                f"{label} {F} field{'s' * (F > 1)}",
                lambda: slice_nbr_values(plan, xf, interior),
                lambda: slice_nbr_values_plain(plan, xf, interior),
                dtype, C * K + 4 * n_int + C * F * sz + C * K * F * sz,
                timed=timed and F == 3, exact=True, outputs=("nbr",),
                library_call=lambda: xf[nbr],
            )
        del A, off, diag, mesh


def _irregular_twins(dev, settings, iterations, chunk=None, mu=None, use_ck="auto"):
    """The same SIMPLE run on a permuted 16^2 f64 cavity on the card and
    on the CPU (one array set compiled twice), at Re 1000 under a TVD
    limiter and Re 100 otherwise unless `mu` is given."""
    from orc_tpu_torch.models.cavity import cavity_case
    from orc_tpu_torch.solver.simple import solve_steady, stack_history

    box, table = cavity_case(n=16, device="cpu")
    out = []
    for d in (dev, torch.device("cpu")):
        mesh, _ = permuted_mesh(box, torch.float64, d, seed=3)
        state, hist = solve_steady(
            mesh, table, settings, 1.0,
            mu if mu is not None else (1e-3 if settings.tvd_psi else 0.01),
            iterations=iterations, reporting_interval=chunk or iterations,
            verbose=False, use_ck=use_ck,
        )
        out.append((state, stack_history(hist)))
    return out


def df32_settings(settings):
    """`settings` with its matrix solves at SolverPrecision.DF32_IR."""
    from orc_tpu_torch.utils.settings import SolverPrecision

    return settings.replace(
        matrix_solver=settings.matrix_solver.replace_precision(SolverPrecision.DF32_IR)
    )


def phase_small_reference_irregular(dev):
    """Phase 3b on the irregular path: parity SIMPLE (solve_cavity's
    numerics, with native and with DF32_IR solves: BiCGSTAB(50),
    Jacobi-preconditioned) and SIMPLE_FC (flagship numerics, with
    Jacobi(50) and with its own BiCGSTAB(50) pressure solve) on a
    permuted 16^2 f64 cavity,
    card against CPU, 10 iterations: equal inner iteration counts, fields
    to 1e-9 of scale (1e-6 for the FC BiCGSTAB pair, whose solve
    amplifies roundoff; ROADMAP Queue 3)."""
    log("== phase 3b: irregular slice on the card vs on the CPU, permuted cavity 16^2 f64, 10 iterations")
    from orc_tpu_torch.models.cavity import default_settings, flagship_settings
    from orc_tpu_torch.utils.settings import MatrixSolverSettings, SolutionMethod

    jacobi = MatrixSolverSettings(solver_type=SolutionMethod.JACOBI, iterations=50)
    runs = (
        ("parity", default_settings(), 1e-9),
        ("parity df32_ir", df32_settings(default_settings()), 1e-9),
        ("fc jacobi", flagship_settings().replace(matrix_solver=jacobi), 1e-9),
        ("fc bicgstab", flagship_settings(), 1e-6),
    )
    for name, settings, tol in runs:
        (sg, hg), (sc, hc) = _irregular_twins(dev, settings, 10)
        fields = ("vel", "p") + (("flux",) if sg.flux is not None else ())
        errs = {n: max_err(getattr(sg, n).cpu(), getattr(sc, n))[1][0] for n in fields}
        same = bool(
            np.array_equal(hg.mom_iters, hc.mom_iters)
            and np.array_equal(hg.pc_iters, hc.pc_iters)
        )
        log(
            f"  {name}: error / scale "
            + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (tol {tol:.0e}); pc_iters card {hg.pc_iters.tolist()} cpu {hc.pc_iters.tolist()}"
        )
        if not same:
            raise AssertionError(f"irregular {name} cuda vs cpu: inner iteration counts differ")
        for n, e in errs.items():
            if not e <= tol:
                raise AssertionError(f"irregular {name} cuda vs cpu {n} differ by {e:.3e} (tol {tol:.0e})")


def bench_irregular_settings():
    """scripts/bench_irregular_simple.py's numerics: forced SIMPLE, UD +
    LinearWeighted, implicit relaxation 0.7 / 0.1, Jacobi-preconditioned
    BiCGSTAB(50)."""
    from orc_tpu_torch.models.cavity import default_settings
    from orc_tpu_torch.utils.settings import PressureVelocityCoupling

    return default_settings().replace(
        pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE
    )


#: Largest difference, relative to the field's scale, allowed between the
#: permuted 448^2 f32 cavity (mapped back to box order) and its
#: structured twin after 30 iterations (measured on the H100: vel
#: 5.3e-6, p 1.7e-5; float32 sums in another order).
IRREGULAR_CAVITY_TOL = 1e-4
#: Relative u_mean difference allowed between the permuted and the
#: structured couette after 300 f64 iterations: the two sum in other
#: orders and the explicitly relaxed BiCGSTAB loop amplifies that
#: (measured after 400 iterations: 1.3e-5 with the plain versions on the
#: CPU, 8.5e-6 on the H100).
IRREGULAR_COUETTE_TOL = 1e-4


def phase_irregular_cavity(dev):
    """scripts/bench_irregular_simple.py on the card: the 448^2 lid
    cavity (200,704 cells) with randomly permuted cells, f32, 5 warm-up +
    25 timed iterations; returns ms/iter and the fields in box order."""
    log("== phase 9: irregular cavity 448^2 f32 (permuted cells), bench_irregular_simple configuration")
    settings = bench_irregular_settings()
    mesh, table, perm = permuted_cavity(448, torch.float32, dev)
    log(f"  {plan_line(mesh)}")
    state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, 1e-3, None, 5, 5)
    state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-3, state, 25, 25)
    irr_ms = 1e3 * dt / 25
    log(
        f"  irregular: warm-up 5 iterations {warm_s:.2f} s; 25 timed "
        f"iterations {dt:.3f} s -> {irr_ms:.2f} ms/iter; pressure iterations "
        f"{hist[-1].pc_iters.cpu().numpy().mean():.2f}"
    )
    profile(mesh, table, settings, 1.0, 1e-3, state, iterations=3)
    return dict(
        ms_per_iter=irr_ms,
        vel=to_box_order(mesh, perm, state.vel.cpu().numpy()),
        p=to_box_order(mesh, perm, state.p.cpu().numpy()),
    )


def phase_irregular_twin(dev, irregular):
    """The structured twin of phase 9, run the same way; the permuted
    run's fields, mapped back to box order, are held against it."""
    log("== phase 9b: structured twin of the irregular cavity, 448^2 f32")
    from orc_tpu_torch.models.cavity import cavity_case

    settings = bench_irregular_settings()
    twin, table = cavity_case(n=448, dtype=torch.float32, device=dev)
    state, _, _ = _timed_solve(twin, table, settings, 1.0, 1e-3, None, 5, 5)
    state, _, dt = _timed_solve(twin, table, settings, 1.0, 1e-3, state, 25, 25)
    st_ms = 1e3 * dt / 25
    log(
        f"  structured twin: {st_ms:.2f} ms/iter; irregular/structured "
        f"ratio {irregular['ms_per_iter'] / st_ms:.2f}x"
    )
    errs = {}
    for name in ("vel", "p"):
        ref = getattr(state, name).cpu().numpy()
        errs[name] = float(np.abs(irregular[name] - ref).max() / np.abs(ref).max())
    log(
        f"  irregular vs structured after 30 iterations: vel {errs['vel']:.3e}, "
        f"p {errs['p']:.3e} of scale (tol {IRREGULAR_CAVITY_TOL:.0e})"
    )
    if not all(np.isfinite(irregular[n]).all() and e <= IRREGULAR_CAVITY_TOL for n, e in errs.items()):
        raise AssertionError("irregular cavity left its structured twin")
    return dict(ms_per_iter=st_ms, ratio=irregular["ms_per_iter"] / st_ms)


def phase_irregular_couette(dev, u_structured):
    """The permuted couette 128x64x1 f64 with bench.py's configuration
    (parity SIMPLE, explicit relaxation): 100 warm-up + 200 timed
    iterations, u_mean within 25% of the analytical value and against
    the structured couette's u_mean (phase 4, as many iterations)."""
    log("== phase 10: irregular couette 128x64x1 f64 (permuted cells), bench.py configuration")
    from orc_tpu_torch.utils.settings import NumericalSettings

    settings = NumericalSettings(matrix_solver=_bicgstab_50())
    box, table = couette_mesh("cpu")
    mesh, _ = permuted_mesh(box, torch.float64, dev, seed=1)
    log(f"  {plan_line(mesh)}")
    state, _, warm_s = _timed_solve(mesh, table, settings, 1000.0, 0.001, None, 100, 100)
    state, hist, dt = _timed_solve(mesh, table, settings, 1000.0, 0.001, state, 200, 100)
    log(
        f"  warm-up 100 iterations {warm_s:.2f} s; 200 timed iterations "
        f"{dt:.3f} s -> {200 / dt:.1f} iters/s ({1e3 * dt / 200:.3f} ms/iter)"
    )
    u = state.vel[:, 0].cpu().numpy()
    if not np.isfinite(u).all():
        raise AssertionError("irregular couette produced non-finite fields")
    check_couette_u_mean(u, 300)
    rel = abs(u.mean() - u_structured) / abs(u_structured)
    log(f"  u_mean against the structured couette {u_structured:.10e}: rel diff {rel:.3e} (tol {IRREGULAR_COUETTE_TOL:.0e})")
    if not rel <= IRREGULAR_COUETTE_TOL:
        raise AssertionError("irregular couette left the structured couette's u_mean")
    profile(mesh, table, settings, 1000.0, 0.001, state, iterations=5)
    return dict(iters_per_s=200 / dt, u_mean=float(u.mean()))


def phase_ref_default_cavity(dev):
    """scripts/bench_cavity.py with ORC_TPU_BENCH_SCHEME=default on the
    card: the 1024^2 f32 cavity at Re = 1000 with the reference's default
    numerics under forced SIMPLE (parity kernels, Rhie-Chow +
    SecondOrder, in-kernel GG), 10 warm-up + 50 timed iterations, finite
    |u| < 2. No plain grad-p pass may run (AsmSpec.gg): the step's
    Green-Gauss pressure gradient is counted. Returns ms/iter and the
    iterations run, which the launch counters must equal."""
    log("== phase 11: reference-default cavity 1024^2 f32 (CD1 + SO + RC, forced SIMPLE), Re=1000")
    from orc_tpu_torch.models.cavity import cavity_case
    from orc_tpu_torch.solver import simple

    settings = ref_default_settings()
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    warm, timed, prof = 10, 50, 5
    passes = []
    real = simple.ck_pressure_gradient

    def counted(*args, **kw):
        passes.append(1)
        return real(*args, **kw)

    simple.ck_pressure_gradient = counted
    try:
        state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, 1e-3, None, warm, warm)
        state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-3, state, timed, timed)
        window = profile(mesh, table, settings, 1.0, 1e-3, state, iterations=prof)
    finally:
        simple.ck_pressure_gradient = real
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.abs(u).max() < 2.0):
        raise AssertionError("reference-default cavity fields not finite or |u| >= 2")
    log(
        f"  warm-up {warm} iterations {warm_s:.2f} s; {timed} timed iterations {dt:.3f} s -> "
        f"{1e3 * dt / timed:.2f} ms/iter; |u| max {np.abs(u).max():.3f}; pressure "
        f"iterations {hist[-1].pc_iters.cpu().numpy().mean():.2f}; plain grad-p passes {len(passes)}"
    )
    if passes:
        raise AssertionError("the in-kernel GG step ran a plain grad-p pass")
    return dict(
        ms_per_iter=1e3 * dt / timed, iterations=warm + timed + prof,
        pc_residual=hist[-1].pc_residual.cpu().numpy(), warm=warm, **window,
    )


#: Largest difference, relative to the field's scale, allowed between the
#: permuted 448^2 f64 cavity solved with DF32_IR and with native f64
#: solves after 30 iterations. The two are different runs: DF32_IR
#: refines every solve three times, which takes the momentum smoother 18
#: sweeps deep instead of 6 and the pressure BiCGSTAB to ~1e-9 instead of
#: 1e-3, so the trajectories part. Ten times the larger gap measured on an
#: NVIDIA H100 80GB HBM3 at 700 W (vel 5.03e-2, p 3.10e-2 of scale).
DF32_CAVITY_TOL = 0.51
#: The same against native f64 solves as deep as DF32_IR's
#: (same_depth_settings), which DF32_IR must track: ten times the larger
#: gap measured on an NVIDIA H100 80GB HBM3 at 700 W (vel 1.00e-9, p
#: 5.3e-10 of scale; the permuted 32^2 cavity on the CPU: 5.7e-10 and
#: 3.0e-10).
DF32_DEPTH_TOL = 1e-8


def same_depth_settings(settings):
    """`settings` at native precision, solved as deep as DF32_IR solves
    them: `refine_steps` restarts of a BiCGSTAB stopped at a relative
    threshold t reach about t ** refine_steps, and `refine_steps`
    refinements of the fixed-count smoother are `refine_steps` times its
    sweeps (a stationary iteration restarted on its residual from zero
    continues unchanged)."""
    ms = settings.matrix_solver
    n = ms.refine_steps
    return settings.replace(matrix_solver=dataclasses.replace(
        ms,
        relative_convergence_threshold=ms.relative_convergence_threshold ** n,
        iterations=n * ms.iterations,
        momentum_iterations=n * ms.momentum_iterations,
    ))


@functools.cache
def _bench_df32_system(dev, C=200_704, K=4, band=450):
    """scripts/bench_df32_ir.py's system: C = 200,704, K = 4, band 450,
    seed 0, orc_tpu's plan choice; ((A64, b64), (A32, b32)), x_true.
    Built once per run: phases 3 and 12 share it."""
    from orc_tpu_torch.mesh.reorder import build_best_slice_plan
    from orc_tpu_torch.ops.spmv import EllMatrix

    rng = np.random.default_rng(0)
    nbrs = np.clip(np.arange(C)[:, None] + rng.integers(-band, band, (C, K)), 0, C - 1)
    valid = nbrs != np.arange(C)[:, None]
    # With the gather table, as a mesh's plan: the kernels line counts
    # launches on a plan without it as kernel 7 on a coarse level.
    plan = build_best_slice_plan(nbrs, valid, build_col_tile=True, device=dev)
    off = rng.standard_normal((C, K)) * valid * 0.2
    diag = np.abs(off).sum(1) + rng.uniform(1.0, 2.0, C)
    x_true = rng.standard_normal(C)
    nb = torch.tensor(nbrs, dtype=torch.int32, device=dev)
    mats = []
    for dt in (torch.float64, torch.float32):
        A = EllMatrix(torch.tensor(diag, dtype=dt, device=dev),
                      torch.tensor(off, dtype=dt, device=dev), nb, plan=plan)
        mats.append((A, A.matvec(torch.tensor(x_true, dtype=dt, device=dev))))
    log(f"  system C={C} K={K} band={band}: plan tile {plan.tile}, n_max {plan.n_max}")
    return mats, x_true


def phase_df32(dev):
    """DF32_IR on the card. (a) scripts/bench_df32_ir.py's system: the
    plain f32 slice-kernel solve, DF32_IR and the native f64 solve (the
    f64 slice SpMV), BiCGSTAB(100) to 1e-8, Jacobi-preconditioned; ms
    per solve (median of 3 after one warm-up) and the error against
    x_true, DF32_IR below 1e-11. (b) The permuted 448^2 cavity in f64
    with bench_irregular_settings() at DF32_IR, at NATIVE and at NATIVE
    as deep as DF32_IR (same_depth_settings), 5 + 25 iterations each:
    ms/iter and the fields' gaps, DF32_IR against the same-depth run
    held at DF32_DEPTH_TOL."""
    log("== phase 12: DF32_IR (df32 iterative refinement) on the card")
    from orc_tpu_torch.solver.krylov import iterative_solve
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        PreconditionMethod,
        SolutionMethod,
        SolverPrecision,
    )

    (m64, m32), x_true = _bench_df32_system(dev)
    ms = MatrixSolverSettings(
        solver_type=SolutionMethod.BICGSTAB, iterations=100,
        relative_convergence_threshold=1e-8,
        preconditioner=PreconditionMethod.JACOBI,
    )
    out = {}
    for label, (A, b), settings in (
        ("f32 slice", m32, ms),
        ("DF32_IR", m64, ms.replace_precision(SolverPrecision.DF32_IR)),
        ("native f64", m64, ms),
    ):
        iterative_solve(A, b, torch.zeros_like(b), settings)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = iterative_solve(A, b, torch.zeros_like(b), settings)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        err = float(np.abs(x.double().cpu().numpy() - x_true).max() / np.abs(x_true).max())
        out[label] = dict(ms=1e3 * float(np.median(times)), err=err)
        log(
            f"  {label}: {out[label]['ms']:.2f} ms/solve, max error / max |x_true| "
            f"{err:.2e}, inner iterations {int(info.iterations)}"
        )
    if not out["DF32_IR"]["err"] < 1e-11:
        raise AssertionError(f"DF32_IR solve error {out['DF32_IR']['err']:.2e} >= 1e-11")
    log(
        f"  DF32_IR / f32: {out['DF32_IR']['ms'] / out['f32 slice']['ms']:.2f}x; "
        f"native f64 / DF32_IR: {out['native f64']['ms'] / out['DF32_IR']['ms']:.2f}x"
    )
    del m64, m32
    fields = {}
    for name, settings in (
        ("DF32_IR", df32_settings(bench_irregular_settings())),
        ("native", bench_irregular_settings()),
        ("native, DF32_IR's depth", same_depth_settings(bench_irregular_settings())),
    ):
        mesh, table, perm = permuted_cavity(448, torch.float64, dev)
        state, _, _ = _timed_solve(mesh, table, settings, 1.0, 1e-3, None, 5, 5)
        state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-3, state, 25, 25)
        out[f"cavity {name}"] = 1e3 * dt / 25
        log(
            f"  permuted cavity 448^2 f64 {name}: {1e3 * dt / 25:.2f} ms/iter; "
            f"pressure iterations {hist[-1].pc_iters.cpu().numpy().mean():.2f}"
        )
        if name == "DF32_IR":
            profile(mesh, table, settings, 1.0, 1e-3, state, iterations=3)
        fields[name] = state
        del mesh
    for ref, tol in (("native", DF32_CAVITY_TOL), ("native, DF32_IR's depth", DF32_DEPTH_TOL)):
        gaps = {
            f: max_err(getattr(fields["DF32_IR"], f), getattr(fields[ref], f))[1][0]
            for f in ("vel", "p")
        }
        log(
            f"  DF32_IR vs {ref} f64 after 30 iterations: vel {gaps['vel']:.3e}, p "
            f"{gaps['p']:.3e} of scale (tol {tol:.1e})"
        )
        if not all(g <= tol for g in gaps.values()):
            raise AssertionError(f"the DF32_IR cavity left the {ref} f64 run")
    return out


# --- k-epsilon RANS, least squares, CD2 and in-matrix TVD ----------------


def tvd_cavity_settings():
    """solve_cavity's numerics with in-matrix TVD momentum (UMIST): one
    matrix per velocity component, implicit relaxation (the 6-sweep
    smoother runs row 2's per-row instance)."""
    from orc_tpu_torch.models.cavity import default_settings
    from orc_tpu_torch.utils.settings import MomentumScheme, tvd_umist

    return default_settings().replace(momentum=MomentumScheme.TVD, tvd_psi=tvd_umist)


def cd2_couette_settings():
    """bench.py's couette numerics with CD2 momentum: explicit relaxation,
    BiCGSTAB(50) Jacobi (row 1's per-row instance in the momentum
    solves)."""
    from orc_tpu_torch.utils.settings import MomentumScheme, NumericalSettings

    return NumericalSettings(momentum=MomentumScheme.CD2, matrix_solver=_bicgstab_50())


def lsq(settings):
    from orc_tpu_torch.utils.settings import GradientReconstruction

    return settings.replace(gradient_reconstruction=GradientReconstruction.LEAST_SQUARES)


def per_row_system(mesh, table, settings, state, rho, mu):
    """The momentum system the (c,k) step solves from `state` under a
    per-component scheme, as the solver sees it: split into [3,C]
    columns and Jacobi-preconditioned. Returns (A, b3, x3)."""
    from orc_tpu_torch.ops.ck_ops import (
        build_ck_geometry,
        ck_bc,
        ck_diffusion,
        ck_face_pressure,
        ck_flux,
        ck_momentum,
        nbr_values,
    )
    from orc_tpu_torch.ops.fields import device_bc
    from orc_tpu_torch.solver import simple

    zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=mesh.device)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    diff = ck_diffusion(mesh, ck, bc, torch.tensor(mu, dtype=mesh.dtype, device=mesh.device))
    gp_fn, gv_fn = simple.gradient_fns(settings)
    vel, p = state.vel, state.p
    grad_p = grad_p_nbr = None
    if simple._needs_grad_p(settings):
        grad_p = gp_fn(mesh, ck, bc, p)
        grad_p_nbr = nbr_values(mesh, grad_p, ck.interior)
    flux = ck_flux(
        mesh, ck, bc, vel, settings.velocity_interpolation, p=p, grad_p=grad_p,
        grad_p_nbr=grad_p_nbr, mom_diag=state.mom_diag.T,
    )
    p_f = ck_face_pressure(
        mesh, ck, bc, p, settings.pressure_interpolation, grad_p=grad_p,
        grad_p_nbr=grad_p_nbr,
    )
    A3, b3, _ = ck_momentum(
        mesh, ck, bc, settings, rho, vel, flux * ck.area * rho, p_f, *diff,
        grad_vel=gv_fn(mesh, ck, bc, vel),
    )
    A, inv_d = A3.split_columns().jacobi_preconditioned()
    return A, (b3 * inv_d).contiguous(), vel.T.contiguous()


def per_row_csr_call(diag, cols, offsets, x):
    """csr_call of B structured matrices, one per batch row, as one
    block-diagonal [B C, B C] matrix times the flattened x."""
    B, C = diag.shape
    i = torch.arange(C, device=diag.device)
    rows, nbrs, vals = [], [], []
    for b in range(B):
        for col, d in zip(cols, offsets):
            ok = ((i + d) >= 0) & ((i + d) < C)
            rows.append(b * C + i[ok])
            nbrs.append(b * C + i[ok] + d)
            vals.append(col[b][ok])
    return csr_call(
        diag.reshape(-1), torch.cat(rows), torch.cat(nbrs), torch.cat(vals),
        x.reshape(-1),
    )


def phase_per_row_kernels(dev, spmv_pr, sweeps_pr):
    """Rows 1 and 2's per-row instances against their plain versions on
    the systems of phase 20: the 1024^2 f32 TVD cavity's momentum system
    after 2 iterations (B = 3, one matrix per component: the shift SpMV,
    with the block-diagonal CSR product as its library yardstick, and
    six Jacobi sweeps) and the 128x64 f64 CD2 couette's after 5."""
    log("== phase 3: per-row branches of rows 1 and 2 (one matrix per velocity component)")
    from orc_tpu_torch.models.cavity import cavity_case
    from orc_tpu_torch.ops.fused_smooth import (
        SweepPlan,
        _launch_sweeps,
        fused_jacobi_sweeps,
        sweep_plan,
        sweeps_plain,
    )
    from orc_tpu_torch.ops.shift_spmv import shift_spmv, shift_spmv_plain
    from orc_tpu_torch.solver.simple import solve_steady

    f32 = 4
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    settings = tvd_cavity_settings()
    state, _ = solve_steady(
        mesh, table, settings, 1.0, TVD_CAVITY_MU, iterations=2,
        reporting_interval=2, verbose=False,
    )
    A, b3, x3 = per_row_system(mesh, table, settings, state, 1.0, TVD_CAVITY_MU)
    C, K = mesh.n_cells, len(A.off)
    log(f"  tvd cavity 1024^2 f32 system: diag {tuple(A.diag.shape)}, {K} [3,C] columns")
    spmv_pr.compare(
        "tvd cavity 1024^2 f32 B=3 per-row",
        lambda: shift_spmv(A.diag, A.off, A.offsets, x3),
        lambda: shift_spmv_plain(A.diag, A.off, A.offsets, x3),
        torch.float32, C * 3 * (1 + K + 2) * f32, timed=True,
        nops=2 * 3 * C * (1 + K),
        library_call=per_row_csr_call(A.diag, A.off, A.offsets, x3),
    )
    log(f"  fused_jacobi_sweeps tvd cavity 1024^2 f32: "
        f"{sweep_plan(A.offsets, C, 6, torch.float32, per_row=True).label()}")
    args = (A.diag, A.off, A.offsets, b3, x3, 6, 0.8)
    plain = lambda: sweeps_plain(*args)  # noqa: E731
    per_sweep = lambda: _launch_sweeps(*args, SweepPlan(per_row=True))  # noqa: E731
    sweeps_pr.compare(
        "tvd cavity 1024^2 f32 B=3 per-row 6 sweeps", lambda: fused_jacobi_sweeps(*args),
        plain, torch.float32, C * 3 * (1 + K + 3) * f32, timed=True, outputs=("x",),
    )
    sweeps_pr.compare(
        "tvd cavity 1024^2 f32 B=3 per-row per-sweep", per_sweep, plain, torch.float32,
        C * 3 * (1 + K + 3) * f32, timed=False, outputs=("x",),
    )
    check_bitwise("tvd cavity 1024^2 f32 B=3 per-row", fused_jacobi_sweeps(*args), per_sweep())
    del A, b3, x3, state, mesh, args
    mesh, table = couette_mesh(dev)
    settings = cd2_couette_settings()
    state, _ = solve_steady(
        mesh, table, settings, 1000.0, 0.001, iterations=5, reporting_interval=5,
        verbose=False,
    )
    A, b3, x3 = per_row_system(mesh, table, settings, state, 1000.0, 0.001)
    C, K = mesh.n_cells, len(A.off)
    spmv_pr.compare(
        "cd2 couette 128x64 f64 B=3 per-row",
        lambda: shift_spmv(A.diag, A.off, A.offsets, x3),
        lambda: shift_spmv_plain(A.diag, A.off, A.offsets, x3),
        torch.float64, C * 3 * (1 + K + 2) * 8, timed=False,
        nops=2 * 3 * C * (1 + K),
        library_call=per_row_csr_call(A.diag, A.off, A.offsets, x3),
    )
    args = (A.diag, A.off, A.offsets, b3, x3, 6, 0.8)
    log(f"  fused_jacobi_sweeps cd2 couette 128x64 f64: "
        f"{sweep_plan(A.offsets, C, 6, torch.float64, per_row=True).label()}")
    sweeps_pr.compare(
        "cd2 couette 128x64 f64 B=3 per-row 6 sweeps", lambda: fused_jacobi_sweeps(*args),
        lambda: sweeps_plain(*args), torch.float64, C * 3 * (1 + K + 3) * 8, timed=False,
        outputs=("x",),
    )
    check_bitwise("cd2 couette 128x64 f64 B=3 per-row", fused_jacobi_sweeps(*args),
                  _launch_sweeps(*args, SweepPlan(per_row=True)))


def rans_channel(dev, nx, ny, dtype):
    """tests/test_turbulence.py channel(): an 8 x 2 x 0.5 channel, walls
    top and bottom, a velocity inlet at 1 and a pressure outlet."""
    from orc_tpu_torch.mesh.generate import structured_box_mesh
    from orc_tpu_torch.mesh.zones import FaceCondition

    mesh, table = structured_box_mesh(
        nx, ny, 1, lengths=(8.0, 2.0, 0.5), dtype=dtype, device=dev
    )
    table.set("TOP_WALL", FaceCondition.WALL)
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("INLET", FaceCondition.VELOCITY_INLET, vector_value=(1.0, 0, 0))
    table.set("OUTLET", FaceCondition.PRESSURE_OUTLET, scalar_value=0.0)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table


def rans_settings():
    """tests/test_turbulence.py SETTINGS: parity SIMPLE, UD +
    LinearWeighted, explicit relaxation 0.6 / 0.05, BiCGSTAB(30) Jacobi."""
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PreconditionMethod,
        PressureInterpolation,
        SolutionMethod,
        VelocityInterpolation,
    )

    return NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.BICGSTAB, iterations=30,
            preconditioner=PreconditionMethod.JACOBI,
        ),
        momentum_relaxation=0.6,
        pressure_relaxation=0.05,
    )


#: The developing channel's turbulence inlet (tests/test_turbulence.py).
CHANNEL_TURB = dict(u_ref=1.0, intensity=0.05, length_scale=0.14)


def _timed_rans(mesh, table, settings, rho, mu, iterations, chunk, carry=None, **kw):
    """solve_steady_turbulent from `carry` = (flow, turb) (or from rest),
    synchronized: (flow, turb, history, wall seconds)."""
    from orc_tpu_torch.solver.turbulence import solve_steady_turbulent

    flow, turb = carry or (None, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flow, turb, hist = solve_steady_turbulent(
        mesh, table, settings, rho, mu, iterations=iterations,
        reporting_interval=chunk, state=flow, turb=turb, verbose=False, **kw,
    )
    torch.cuda.synchronize()
    return flow, turb, hist, time.perf_counter() - t0


#: The RANS channel's card-against-CPU tolerance after 10 iterations:
#: the k-epsilon loop amplifies roundoff about tenfold every four
#: iterations (orc_tpu against the port on the CPU: 2e-10 of scale at
#: iteration 10, 1.7e-6 at 40; ROADMAP Queue 3), and the card's fused
#: multiply-adds start it larger: 3.2e-8 of scale (vel; mu_t 5.2e-8)
#: measured on an NVIDIA H100 80GB HBM3 at 700 W, with equal inner
#: iteration counts. Thirty times that.
RANS_CARD_CPU_TOL = 1e-6


def phase_small_reference_schemes(dev):
    """Phase 3b for this slice's numerics, card against CPU, f64, equal
    inner iteration counts, fields to 1e-9 of their scale: the developing
    RANS channel 16x12 (10 iterations; vel, p, k, eps, mu_t; to 1e-6,
    RANS_CARD_CPU_TOL), and the 16^2
    cavity under least squares with in-matrix TVD (1 iteration: the
    limiter flips branches on rounding, and the permuted cavity parted by
    1.6e-3 of scale within 5 on an H100) and with CD2 (10 iterations),
    forced SIMPLE, Rhie-Chow, structured and permuted (the permuted ones
    run the slice SpMV with one matrix per component and, under CD2, the
    9-field velocity-gradient gather)."""
    log("== phase 3b: RANS channel 16x12 f64 on the card vs on the CPU, 10 iterations")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings
    from orc_tpu_torch.solver.simple import solve_steady, stack_history
    from orc_tpu_torch.utils.settings import (
        MomentumScheme,
        PressureVelocityCoupling,
        VelocityInterpolation,
        tvd_umist,
    )

    from orc_tpu_torch.solver.turbulence import solve_steady_turbulent

    out = []
    for d in (dev, torch.device("cpu")):
        mesh, table = rans_channel(d, 16, 12, torch.float64)
        flow, turb, hist = solve_steady_turbulent(
            mesh, table, rans_settings(), 1.0, 1e-5, iterations=10,
            reporting_interval=10, verbose=False, **CHANNEL_TURB,
        )
        fields = types.SimpleNamespace(
            vel=flow.vel, p=flow.p, k=turb.k, eps=turb.eps, mu_t=turb.mu_t
        )
        out.append((fields, stack_history(hist)))
    _card_cpu_gap(
        "rans channel", out, RANS_CARD_CPU_TOL, fields=("vel", "p", "k", "eps", "mu_t")
    )
    base = default_settings().replace(
        pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
    )
    runs = {
        "lsq tvd": lsq(base.replace(momentum=MomentumScheme.TVD, tvd_psi=tvd_umist)),
        "lsq cd2": lsq(base.replace(momentum=MomentumScheme.CD2)),
    }
    for name, settings in runs.items():
        n = 1 if settings.momentum == MomentumScheme.TVD else 10
        log(f"== phase 3b: {name} cavity 16^2 f64 on the card vs on the CPU, structured and permuted, {n} iterations")
        out = []
        for d in (dev, torch.device("cpu")):
            mesh, table = cavity_case(n=16, device=d)
            state, hist = solve_steady(
                mesh, table, settings, 1.0, 0.01, iterations=n,
                reporting_interval=n, verbose=False,
            )
            out.append((state, stack_history(hist)))
        _card_cpu_gap(f"{name} structured", out, 1e-9, fields=("vel", "p", "mom_diag"))
        _card_cpu_gap(
            f"{name} permuted", _irregular_twins(dev, settings, n, mu=0.01), 1e-9,
            fields=("vel", "p", "mom_diag"),
        )


def rans_split(mesh, table, settings, rho, mu, carry, iterations, **kw):
    """Wall seconds of `iterations` RANS iterations and of their
    turbulence_step calls (each synchronized), the SIMPLE step being the
    rest."""
    from orc_tpu_torch.solver import turbulence

    spent = []
    real = turbulence.turbulence_step

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    turbulence.turbulence_step = timed
    try:
        wall = _timed_rans(mesh, table, settings, rho, mu, iterations, iterations, carry, **kw)[3]
    finally:
        turbulence.turbulence_step = real
    return wall, sum(spent)


def phase_rans_channel(dev):
    """The developing RANS channel at full width: 1024 x 512 x 1 f32 with
    tests/test_turbulence.py's geometry, boundary conditions and SETTINGS
    (parity SIMPLE, UD, BiCGSTAB(30) Jacobi, rho 1, mu 1e-5) under
    implicit relaxation with SETTINGS' factors (0.6 / 0.05): with the
    test's explicit relaxation the channel diverges on any mesh finer
    than the test's 16 x 12, in orc_tpu as in the port (measured on the
    CPU: |u| above 1e18 within 40 iterations at 32 x 16, 64 x 32 and 256 x
    128, in f32 and f64), while under implicit relaxation orc_tpu's 256 x
    128 f32 channel stays bounded (u_mean 0.335, max |u| 3.6 after 40).
    Its momentum and k/eps solves then run the 6-sweep smoother (row 2).
    10 warm-up + 30 timed iterations, finite fields, k > 0, mu_t <= 1e5
    mu; ms/iter, a profile window of 3 iterations (launches per
    iteration, busy share) and the split between the SIMPLE step and
    turbulence_step over 5 synchronized iterations."""
    from orc_tpu_torch.utils.settings import RelaxationMode

    log("== phase 17: RANS developing channel 1024x512x1 f32 (k-epsilon, wall functions, implicit relaxation)")
    mesh, table = rans_channel(dev, 1024, 512, torch.float32)
    s = rans_settings().replace(relaxation_mode=RelaxationMode.IMPLICIT)
    rho, mu = 1.0, 1e-5
    flow, turb, _, warm = _timed_rans(mesh, table, s, rho, mu, 10, 10, **CHANNEL_TURB)
    flow, turb, hist, wall = _timed_rans(mesh, table, s, rho, mu, 30, 30, (flow, turb), **CHANNEL_TURB)
    vel, k, mu_t = (t.cpu().numpy() for t in (flow.vel, turb.k, turb.mu_t))
    ok = bool(np.isfinite(vel).all() and np.isfinite(k).all() and np.isfinite(mu_t).all())
    log(
        f"  warm-up 10 iterations {warm:.2f} s; 30 timed iterations {wall:.3f} s -> "
        f"{1e3 * wall / 30:.2f} ms/iter; u_mean {vel[:, 0].mean():.4f}; k min {k.min():.3e}; "
        f"mu_t/mu max {mu_t.max() / mu:.1f}; pressure iterations "
        f"{hist[-1].pc_iters.float().mean().item():.2f}; finite {ok}"
    )
    if not (ok and (k > 0).all() and mu_t.max() <= 1e5 * mu * (1 + 1e-6)):
        raise AssertionError("RANS channel: non-finite fields, k <= 0 or mu_t above 1e5 mu")
    split_wall, turb_s = rans_split(mesh, table, s, rho, mu, (flow, turb), 5, **CHANNEL_TURB)
    log(
        f"  split over 5 synchronized iterations: {1e3 * split_wall / 5:.2f} ms/iter, "
        f"SIMPLE step {1e3 * (split_wall - turb_s) / 5:.2f} ms, turbulence_step "
        f"{1e3 * turb_s / 5:.2f} ms ({100 * turb_s / split_wall:.1f}%)"
    )
    prof = profile_window(
        lambda: _timed_rans(mesh, table, s, rho, mu, 3, 3, (flow, turb), **CHANNEL_TURB)[3], 3
    )
    return dict(ms_per_iter=1e3 * wall / 30, turb_share=turb_s / split_wall, **prof)


def re_tau_channel(dev, ny):
    """tests/test_turbulence.py test_channel_re_tau_590: 4 x ny f64, x
    periodic, walls top and bottom, driven by the body force G V."""
    from orc_tpu_torch.mesh.generate import structured_box_mesh
    from orc_tpu_torch.mesh.zones import FaceCondition

    mesh, table = structured_box_mesh(
        4, ny, 1, lengths=(4.0, RE_TAU_H, 0.2), periodic=("x",), device=dev
    )
    table.set("BOTTOM_WALL", FaceCondition.WALL)
    table.set("TOP_WALL", FaceCondition.WALL)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    force = (1.0 / (RE_TAU_H / 2)) * float(mesh.cell_volume[0])

    def source(cc):
        s = torch.zeros_like(cc)
        s[:, 0] = force
        return s

    return mesh, table, source


RE_TAU, RE_TAU_H = 590.0, 2.0
#: test_channel_re_tau_590's turbulence start.
RE_TAU_TURB = dict(u_ref=18.0, intensity=0.05, length_scale=0.2 * RE_TAU_H)


def re_tau_settings(source, fc):
    """test_channel_re_tau_590's numerics (parity SIMPLE, UD +
    LinearWeighted pressure + Rhie-Chow, explicit relaxation,
    BiCGSTAB(30)), or under SIMPLE_FC with implicit relaxation 0.6 / 0.3
    (test_sharded_turbulent_fc_matches_single_device's)."""
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        PressureVelocityCoupling,
        RelaxationMode,
        SolutionMethod,
        VelocityInterpolation,
    )

    s = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
        matrix_solver=MatrixSolverSettings(solver_type=SolutionMethod.BICGSTAB, iterations=30),
        momentum_source=source,
    )
    if fc:
        s = s.replace(
            pressure_velocity_coupling=PressureVelocityCoupling.SIMPLE_FC,
            relaxation_mode=RelaxationMode.IMPLICIT,
            momentum_relaxation=0.6, pressure_relaxation=0.3,
        )
    return s


def phase_re_tau(dev, fc=False):
    """The Re_tau = 590 channel, ny = 16 f64, 800 iterations, on the card:
    the parity run held to test_channel_re_tau_590's DNS bars (U_b+ within
    10% of 18.5, U_c+ within 5% of 21.26, the wall cell on the log law
    within 5%, its k within 10% of 1/sqrt(C_mu)); the SIMPLE_FC run
    (implicit 0.6 / 0.3: its momentum and k/eps solves run row 2's
    per-sweep instance, the box being periodic) held to orc_tpu's profile
    ORC_TPU_RE_TAU_FC_U_PROFILE_800 at rtol 1e-2. Finite fields; ms/iter
    and a profile window of 3 iterations."""
    from orc_tpu_torch.solver.turbulence import E_WALL, KAPPA

    name = "SIMPLE_FC" if fc else "parity"
    log(f"== phase 18: Re_tau = 590 channel 4x16 f64, {name}, 800 iterations")
    ny = 16
    mesh, table, source = re_tau_channel(dev, ny)
    s, mu = re_tau_settings(source, fc), RE_TAU_H / 2 / RE_TAU
    flow, turb, hist, wall = _timed_rans(mesh, table, s, 1.0, mu, 800, 800, **RE_TAU_TURB)
    u = flow.vel[:, 0].cpu().numpy().reshape(ny, 4)
    prof_u = u.mean(axis=1)
    k1 = turb.k.cpu().numpy().reshape(ny, 4).mean(axis=1)[0]
    finite = bool(np.isfinite(flow.vel.cpu().numpy()).all() and np.isfinite(turb.k.cpu().numpy()).all())
    U_b, U_c = prof_u.mean(), prof_u.max()
    yp1 = RE_TAU * (RE_TAU_H / ny) / 2
    log_law = np.log(E_WALL * yp1) / KAPPA
    log(
        f"  800 iterations {wall:.2f} s -> {1e3 * wall / 800:.2f} ms/iter; U_b+ {U_b:.3f} "
        f"U_c+ {U_c:.3f} wall cell u+ {prof_u[0]:.3f} (log law {log_law:.3f}) k+ {k1:.3f} "
        f"(1/sqrt(C_mu) {0.09 ** -0.5:.3f}); finite {finite}"
    )
    if not finite:
        raise AssertionError(f"Re_tau {name}: non-finite fields")
    if fc:
        ref = np.asarray(ORC_TPU_RE_TAU_FC_U_PROFILE_800)
        rel = float(np.abs(prof_u - ref).max() / np.abs(ref).max())
        log(f"  profile against orc_tpu's: max difference / max {rel:.3e} (limit 1e-2)")
        if not rel < 1e-2:
            raise AssertionError("Re_tau SIMPLE_FC left orc_tpu's profile")
    else:
        bars = (
            abs(U_b - 18.5) / 18.5 < 0.10,
            abs(U_c - 21.26) / 21.26 < 0.05,
            abs(prof_u[0] - log_law) < 0.05 * prof_u[0],
            abs(k1 - 0.09 ** -0.5) / 0.09 ** -0.5 < 0.10,
        )
        if not all(bars):
            raise AssertionError(f"Re_tau parity run missed a DNS bar: {bars}")
    prof = profile_window(
        lambda: _timed_rans(mesh, table, s, 1.0, mu, 3, 3, (flow, turb), **RE_TAU_TURB)[3], 3
    )
    return dict(ms_per_iter=1e3 * wall / 800, **prof)


def _lsq_timings(mesh, table, state):
    """Card times of the least-squares pieces at the 1024^2 f32 shapes:
    the batched 2 x 2 solves of [C, 2, 2] (closed form, and
    torch.linalg.solve_ex as a yardstick) and the two ck_lsq gradients."""
    from orc_tpu_torch.ops import gradients
    from orc_tpu_torch.ops.ck_ops import (
        build_ck_geometry,
        ck_bc,
        ck_lsq_pressure_gradient,
        ck_lsq_velocity_gradient,
    )
    from orc_tpu_torch.ops.fields import device_bc

    C = mesh.n_cells
    g = torch.Generator(device=mesh.device).manual_seed(0)
    m = torch.randn((C, 2, 2), generator=g, device=mesh.device, dtype=mesh.dtype)
    a = m @ m.transpose(1, 2) + torch.eye(2, device=mesh.device, dtype=mesh.dtype)
    b = torch.randn((C, 2), generator=g, device=mesh.device, dtype=mesh.dtype)
    zc, zs, zv = device_bc(table, dtype=mesh.dtype, device=mesh.device)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    bc = ck_bc(ck, zc, zs, zv)
    g = {(0, 0): a[:, 0, 0], (0, 1): a[:, 0, 1], (1, 1): a[:, 1, 1]}
    calls = {
        f"solve [{C}, 2, 2] closed form": lambda: gradients._cramer(g, [b[:, 0], b[:, 1]]),
        f"solve [{C}, 2, 2] torch.linalg.solve_ex": lambda: torch.linalg.solve_ex(
            a, b[..., None], check_errors=False
        )[0],
        "ck_lsq_pressure_gradient": lambda: ck_lsq_pressure_gradient(mesh, ck, bc, state.p),
        "ck_lsq_velocity_gradient": lambda: ck_lsq_velocity_gradient(mesh, ck, bc, state.vel),
    }
    out = {}
    for name, fn in calls.items():
        ev = time_ms(fn)
        out[name] = card_ms(fn, ev)
        log(f"  {name}: events {ev:.4f} ms, card {out[name]:.4f} ms")
    return out


def phase_lsq(dev, fc=False):
    """Least squares at 1024^2 f32, 10 warm-up + 50 timed iterations,
    finite |u| < 2: refdef-1M's configuration (CD1 + SO + RC, forced
    SIMPLE; the parity kernels' streamed-gradient instances, AsmSpec.gg
    False, the least-squares grad p pass once per iteration) or the
    SIMPLE_FC flagship numerics (rows 4 and 6 with least-squares grad p
    and grad vel); the least-squares pieces timed on the card."""
    from orc_tpu_torch.models.cavity import cavity_case, flagship_settings
    from orc_tpu_torch.ops.ck_ops import build_ck_geometry
    from orc_tpu_torch.solver import simple

    if fc:
        log("== phase 19: SIMPLE_FC cavity 1024^2 f32, flagship numerics with least squares, Re=1000")
        settings = lsq(flagship_settings())
    else:
        log("== phase 19: reference-default cavity 1024^2 f32 with least squares (CD1 + SO + RC, forced SIMPLE), Re=1000")
        settings = lsq(ref_default_settings())
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    ck = build_ck_geometry(mesh, len(table.zone_ids))
    spec = simple._kernel_asm_spec(mesh, table, settings, ck, fc=fc)[1]
    log(f"  kernel spec: scheme {spec.scheme} rc {spec.rc} p_so {spec.p_so} gg {spec.gg}")
    if spec.gg:
        raise AssertionError("least squares took the in-kernel Green-Gauss instance")
    del ck
    passes = []
    real = simple.ck_lsq_pressure_gradient

    def counted(*a, **k):
        passes.append(1)
        return real(*a, **k)

    simple.ck_lsq_pressure_gradient = counted
    warm, timed, prof_n = 10, 50, 5
    try:
        state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, 1e-3, None, warm, warm)
        state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-3, state, timed, timed)
        prof = profile(mesh, table, settings, 1.0, 1e-3, state, iterations=prof_n)
    finally:
        simple.ck_lsq_pressure_gradient = real
    n = warm + timed + prof_n
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.abs(u).max() < 2.0):
        raise AssertionError("least-squares cavity fields not finite or |u| >= 2")
    log(
        f"  warm-up {warm} iterations {warm_s:.2f} s; {timed} timed iterations {dt:.3f} s -> "
        f"{1e3 * dt / timed:.2f} ms/iter; |u| max {np.abs(u).max():.3f}; pressure "
        f"iterations {hist[-1].pc_iters.cpu().numpy().mean():.2f}; least-squares grad p "
        f"passes {len(passes)} in {n} iterations"
    )
    # SIMPLE_FC seeds its stored flux with one more pass (ck_initial_flux).
    if len(passes) != n + fc:
        raise AssertionError("the least-squares grad p pass did not run once per iteration")
    lsq_ms = _lsq_timings(mesh, table, state)
    return dict(ms_per_iter=1e3 * dt / timed, iterations=n, lsq_ms=lsq_ms, **prof)


#: The TVD cavity's viscosity: Re = 100. At solve_cavity's Re = 1000
#: in-matrix TVD (whose inflow faces take the central coefficient,
#: PARITY.md) diverges, in orc_tpu as in the port (measured on the CPU in
#: f32: the 24^2 cavity at iteration 10, the 128^2 at 50); at Re = 100
#: orc_tpu's 128^2 cavity runs 60 iterations with max |u| 0.946.
TVD_CAVITY_MU = 1e-2


def phase_tvd_cavity(dev):
    """tvd-cavity-1M: the 1024^2 f32 cavity with in-matrix TVD (UMIST)
    momentum and solve_cavity's other numerics (implicit 0.7 / 0.1) at Re
    = 100 (TVD_CAVITY_MU): one matrix per component, so the momentum
    smoother runs row 2's per-row instance and the residuals row 1's. 10
    warm-up + 50 timed iterations, finite |u| < 2."""
    log("== phase 20: TVD cavity 1024^2 f32 (in-matrix TVD, UMIST), Re=100")
    from orc_tpu_torch.models.cavity import cavity_case

    settings = tvd_cavity_settings()
    mu = TVD_CAVITY_MU
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, mu, None, 10, 10)
    state, hist, dt = _timed_solve(mesh, table, settings, 1.0, mu, state, 50, 50)
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.abs(u).max() < 2.0):
        raise AssertionError("TVD cavity fields not finite or |u| >= 2")
    log(
        f"  warm-up 10 iterations {warm_s:.2f} s; 50 timed iterations {dt:.3f} s -> "
        f"{1e3 * dt / 50:.2f} ms/iter; |u| max {np.abs(u).max():.3f}; pressure "
        f"iterations {hist[-1].pc_iters.cpu().numpy().mean():.2f}"
    )
    prof = profile(mesh, table, settings, 1.0, mu, state, iterations=3)
    return dict(ms_per_iter=1e3 * dt / 50, **prof)


def phase_cd2_couette(dev):
    """cd2-couette: bench.py's couette 128x64 f64 with CD2 momentum
    (explicit relaxation, BiCGSTAB(50) Jacobi: row 1's per-row instance
    in the momentum solves), 100 warm-up + 200 timed iterations, u_mean
    within 25% of the analytical 1.0833e-3 (orc_tpu's own u_mean after
    those 300 iterations, JAX on CPU in f64, is 1.08453e-3)."""
    log("== phase 20: CD2 couette 128x64x1 f64, bench.py numerics with CD2 momentum")
    settings = cd2_couette_settings()
    mesh, table = couette_mesh(dev)
    state, _, warm_s = _timed_solve(mesh, table, settings, 1000.0, 0.001, None, 100, 100)
    state, hist, dt = _timed_solve(mesh, table, settings, 1000.0, 0.001, state, 200, 100)
    u = state.vel[:, 0].cpu().numpy()
    if not np.isfinite(u).all():
        raise AssertionError("CD2 couette produced non-finite fields")
    mom_it = np.concatenate([h.mom_iters.cpu().numpy() for h in hist])
    log(
        f"  warm-up 100 iterations {warm_s:.2f} s; 200 timed iterations {dt:.3f} s -> "
        f"{200 / dt:.1f} iters/s ({1e3 * dt / 200:.3f} ms/iter); mean momentum iterations "
        f"{mom_it.mean(axis=0).round(2).tolist()}"
    )
    check_couette_u_mean(u, 300)
    prof = profile(mesh, table, settings, 1000.0, 0.001, state, iterations=5)
    return dict(ms_per_iter=1e3 * dt / 200, u_mean=float(u.mean()), **prof)


# --- the face-major step (phases 3b and 21) -----------------------------


def smoke_dir():
    """build/chip_smoke/ in the checkout (git-ignored), for the TGRID
    files the face-major phases write."""
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
    path.mkdir(parents=True, exist_ok=True)
    return path


class CkGeometryBuilds:
    """Counts CKGeometry builds by solve_steady while installed: a run on
    the face-major step builds none."""

    def __enter__(self):
        from orc_tpu_torch.solver import simple

        self.mod, self.real, self.calls = simple, simple.build_ck_geometry, 0

        def counted(*a, **k):
            self.calls += 1
            return self.real(*a, **k)

        simple.build_ck_geometry = counted
        return self

    def __exit__(self, *exc):
        self.mod.build_ck_geometry = self.real


def launch_snapshot():
    """(shift SpMV launches, Jacobi-sweep launches, sweep instances) now."""
    from orc_tpu_torch.ops.fused_smooth import fused_jacobi_sweeps
    from orc_tpu_torch.ops.shift_spmv import shift_spmv

    return (
        shift_spmv.launches, fused_jacobi_sweeps.launches,
        dict(fused_jacobi_sweeps.instances),
    )


def launch_structure(before, hist, settings):
    """The launches of rows 1 and 2 per outer iteration since `before`
    (launch_snapshot) over the iterations of `hist`: sweep launches, the
    sweep instances' calls, shift SpMV launches, and those outside the
    pressure BiCGSTAB loop (each loop iteration runs two SpMVs; the loop
    checks its exit every EXIT_CHECK_EVERY iterations, so it runs
    ceil(pc_iters / 8) * 8 of them, at most the cap)."""
    from orc_tpu_torch.solver.krylov import EXIT_CHECK_EVERY

    spmv0, sweeps0, inst0 = before
    spmv1, sweeps1, inst1 = launch_snapshot()
    pc = np.concatenate([h.pc_iters.cpu().numpy() for h in hist]).astype(np.int64)
    n = pc.shape[0]
    every = EXIT_CHECK_EVERY
    loop = np.where(pc == 0, 0, np.minimum(
        settings.matrix_solver.iterations, -(-pc // every) * every
    ))
    return dict(
        sweeps_per_iter=(sweeps1 - sweeps0) / n,
        instances={k: (v - inst0.get(k, 0)) / n for k, v in inst1.items() if v != inst0.get(k, 0)},
        spmv_per_iter=(spmv1 - spmv0) / n,
        spmv_outside_krylov_per_iter=(spmv1 - spmv0 - 2 * int(loop.sum())) / n,
        pc_iters_mean=float(pc.mean()),
    )


class LastPressureSolve:
    """Keeps the matrix, right-hand side and solution of the last
    pressure solve of solve_steady's steps while installed."""

    def __enter__(self):
        from orc_tpu_torch.solver import simple

        self.mod, self.real, self.last = simple, simple._solve_p_prime, None

        def kept(Pmat, b_p, *a, **k):
            out = self.real(Pmat, b_p, *a, **k)
            self.last = (Pmat, b_p, out[0])
            return out

        simple._solve_p_prime = kept
        return self

    def __exit__(self, *exc):
        self.mod._solve_p_prime = self.real

    def residual(self):
        """b - A p of the last pressure solve, per cell."""
        Pmat, b, x = self.last
        return b - Pmat.matvec(x)


def _ck_flux_divergence(mesh, flux):
    """(max |sum_k flux A|, max |flux A|) over the cells of a (c,k) [C,K]
    flux (already oriented outward)."""
    area = mesh.face_area[mesh.cell_faces.long()]
    fa = torch.where(mesh.cell_face_mask, flux * area, torch.zeros((), dtype=area.dtype, device=area.device))
    return float(fa.sum(dim=1).abs().max()), float(fa.abs().max())


def _face_flux_divergence(mesh, flux):
    """(max |sum_k sgn flux A|, max |flux A|) over the cells of a face-major
    [F] flux."""
    cf = mesh.cell_faces.long()
    fa = mesh.cell_face_sign * flux[cf] * mesh.face_area[cf]
    fa = torch.where(mesh.cell_face_mask, fa, torch.zeros((), dtype=fa.dtype, device=fa.device))
    return float(fa.sum(dim=1).abs().max()), float(fa.abs().max())


def gg_node_tgrid(n, dev, dtype=torch.float64, permuted=False, nodes=True):
    """The n^2 lid-driven cavity as a TGRID file (write_tgrid, cavity_case's
    geometry), its cells relabelled by permuted_tgrid when `permuted`, read
    back with read_mesh(nodes=...) onto `dev`: (mesh, table, read seconds)."""
    from orc_tpu_torch.mesh.generate import write_tgrid
    from orc_tpu_torch.mesh.tgrid import read_mesh
    from orc_tpu_torch.mesh.zones import FaceCondition

    path = smoke_dir() / f"cavity{n}.msh"
    write_tgrid(str(path), n, n, 1, lengths=(1.0, 1.0, 1.0 / n))
    if permuted:
        src, path = path, smoke_dir() / f"cavity{n}-permuted.msh"
        permuted_tgrid(str(src), str(path), seed=3)
    t0 = time.perf_counter()
    mesh, table = read_mesh(str(path), dtype=dtype, nodes=nodes, device=dev)
    read_s = time.perf_counter() - t0
    table.set("TOP_WALL", FaceCondition.WALL, vector_value=(1.0, 0.0, 0.0))
    for zone in ("BOTTOM_WALL", "INLET", "OUTLET"):
        table.set(zone, FaceCondition.WALL)
    table.set("PERIODIC_-Z", FaceCondition.SYMMETRY)
    table.set("PERIODIC_+Z", FaceCondition.SYMMETRY)
    return mesh, table, read_s


def gg_node_settings():
    """solve_cavity's numerics with node-based Green-Gauss gradients and
    TVD_DC (UMIST) momentum, whose limiter reads the velocity gradient
    (tests/test_torch_nodes.py's steady solve)."""
    from orc_tpu_torch.models.cavity import default_settings
    from orc_tpu_torch.utils.settings import (
        GradientReconstruction,
        MomentumScheme,
        tvd_umist,
    )

    return default_settings().replace(
        gradient_reconstruction=GradientReconstruction.GREEN_GAUSS_NODE,
        momentum=MomentumScheme.TVD_DC,
        tvd_psi=tvd_umist,
    )


def phase_small_reference_face_major(dev):
    """Phase 3b on the face-major step (use_ck=False; "auto" for GG
    node), card against CPU, float64, 10 iterations, equal inner
    iteration counts and fields to 1e-9 of scale: the 16^2 cavity with
    the reference's default numerics (CD1 + SecondOrder + Rhie-Chow,
    forced SIMPLE), structured and permuted; SIMPLE_FC with the flagship
    numerics and a Jacobi(50) pressure solve (flux included); the
    transient slice (3 steps x 4 inner iterations, solve_cavity's
    numerics); and node-based Green-Gauss on a 16^2 TGRID cavity read
    with read_mesh(nodes=True), structured and with relabelled cells."""
    log("== phase 3b: face-major step on the card vs on the CPU, 16^2 f64")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings, flagship_settings
    from orc_tpu_torch.solver.simple import solve_steady, stack_history
    from orc_tpu_torch.solver.transient import solve_transient
    from orc_tpu_torch.utils.settings import MatrixSolverSettings, SolutionMethod

    jacobi = MatrixSolverSettings(solver_type=SolutionMethod.JACOBI, iterations=50)
    kw = dict(iterations=10, reporting_interval=10, verbose=False, use_ck=False)
    for name, settings, mu in (
        ("face-major reference default", ref_default_settings(), 0.01),
        ("face-major SIMPLE_FC jacobi", flagship_settings().replace(matrix_solver=jacobi), 1e-3),
    ):
        out = []
        for d in (dev, torch.device("cpu")):
            mesh, table = cavity_case(n=16, device=d)
            state, hist = solve_steady(mesh, table, settings, 1.0, mu, **kw)
            out.append((state, stack_history(hist)))
        fields = ("vel", "p") + (("flux",) if out[0][0].flux is not None else ())
        _card_cpu_gap(name, out, 1e-9, fields)
        if out[0][0].flux is not None:
            div, scale = _face_flux_divergence(mesh, out[1][0].flux)
            log(f"  {name}: max |div flux| / max |flux A| = {div / scale:.3e} (CPU)")
    _card_cpu_gap(
        "face-major reference default, permuted",
        _irregular_twins(dev, ref_default_settings(), 10, mu=0.01, use_ck=False), 1e-9,
    )
    out = []
    for d in (dev, torch.device("cpu")):
        mesh, table = cavity_case(n=16, device=d)
        out.append(solve_transient(
            mesh, table, default_settings(), 1.0, 0.01, dt=0.05, n_steps=3,
            inner_iterations=4, verbose=False, use_ck=False,
        ))
    _card_cpu_gap("face-major transient SIMPLE", out, 1e-9)
    for permuted in (False, True):
        out = []
        for d in (dev, torch.device("cpu")):
            mesh, table, _ = gg_node_tgrid(16, d, permuted=permuted)
            with CkGeometryBuilds() as builds:
                state, hist = solve_steady(
                    mesh, table, gg_node_settings(), 1.0, 0.01, iterations=10,
                    reporting_interval=10, verbose=False,
                )
            if builds.calls:
                raise AssertionError("GG node under use_ck='auto' took the (c,k) step")
            out.append((state, stack_history(hist)))
        _card_cpu_gap(f"GG node TGRID 16^2{' permuted' if permuted else ''}", out, 1e-9)


#: Largest relative difference allowed between the face-major couette's
#: u_mean and the (c,k) couette's (phase 4) after 300 iterations: the
#: two steps sum in different orders and the explicitly relaxed
#: BiCGSTAB loop amplifies it, as for the permuted couette.
FACE_MAJOR_COUETTE_TOL = 1e-4


def phase_fm_couette(dev, u_ck):
    """21a, fm-couette: bench.py's couette on the face-major step
    (use_ck=False), 100 warm-up + 200 timed iterations, u_mean within 25%
    of the analytical value and within FACE_MAJOR_COUETTE_TOL of phase
    4's (c,k) u_mean."""
    log("== phase 21a: fm-couette 128x64x1 f64, bench.py configuration, face-major step")
    from orc_tpu_torch.utils.settings import NumericalSettings

    settings = NumericalSettings(matrix_solver=_bicgstab_50())
    mesh, table = couette_mesh(dev)
    with CkGeometryBuilds() as builds:
        state, _, warm_s = _timed_solve(mesh, table, settings, 1000.0, 0.001, None, 100, 100, False)
        state, hist, dt = _timed_solve(mesh, table, settings, 1000.0, 0.001, state, 200, 100, False)
    if builds.calls:
        raise AssertionError("use_ck=False built a CKGeometry")
    pc_it = np.concatenate([h.pc_iters.cpu().numpy() for h in hist])
    log(
        f"  warm-up 100 iterations {warm_s:.2f} s; 200 timed iterations "
        f"{dt:.3f} s -> {200 / dt:.1f} iters/s ({1e3 * dt / 200:.3f} ms/iter); "
        f"mean pressure iterations {pc_it.mean():.2f}"
    )
    u = state.vel[:, 0].cpu().numpy()
    if not np.isfinite(u).all():
        raise AssertionError("fm-couette produced non-finite fields")
    check_couette_u_mean(u, 300)
    rel = abs(u.mean() - u_ck) / abs(u_ck)
    log(f"  u_mean against the (c,k) couette {u_ck:.10e}: rel diff {rel:.3e} (tol {FACE_MAJOR_COUETTE_TOL:.0e})")
    if not rel <= FACE_MAJOR_COUETTE_TOL:
        raise AssertionError("fm-couette left the (c,k) couette's u_mean")
    prof = profile(mesh, table, settings, 1000.0, 0.001, state, iterations=5, use_ck=False)
    return dict(ms_per_iter=1e3 * dt / 200, u_mean=float(u.mean()), **prof)


def phase_fm_cavity(dev, twin):
    """21b, fm-cavity-1M: cavity-1M's numerics (solve_cavity's) on the
    face-major step, 10 warm-up + 50 timed iterations: finite, |u| < 2,
    the gap to the (c,k) twin's vel_avg (phase 5), and the same Jacobi
    sweep instance, sweep launches and shift SpMV launches outside the
    pressure Krylov loop per iteration as the twin."""
    log("== phase 21b: fm-cavity-1M 1024^2 f32, solve_cavity configuration, face-major step")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings

    settings = default_settings()
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    with CkGeometryBuilds() as builds:
        state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, 1e-3, None, 10, 10, False)
        before = launch_snapshot()
        state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-3, state, 50, 50, False)
        structure = launch_structure(before, hist, settings)
    if builds.calls:
        raise AssertionError("use_ck=False built a CKGeometry")
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.abs(u).max() < 2.0):
        raise AssertionError("fm-cavity fields not finite or |u| >= 2")
    va = hist[-1].vel_avg[-1].cpu().numpy()
    gap = float(np.abs(va - twin["vel_avg"]).max() / np.abs(twin["vel_avg"]).max())
    log(
        f"  warm-up 10 iterations {warm_s:.2f} s; 50 timed iterations {dt:.3f} s "
        f"-> {1e3 * dt / 50:.2f} ms/iter ((c,k) twin {twin['ms_per_iter']:.2f}); "
        f"|u| max {np.abs(u).max():.3f}; vel_avg {va.tolist()} vs (c,k) twin "
        f"{twin['vel_avg'].tolist()}: gap {gap:.3e} of scale"
    )
    log(f"  launch structure, face-major: {structure}")
    log(f"  launch structure, (c,k) twin: {twin['structure']}")
    for key in ("instances", "sweeps_per_iter", "spmv_outside_krylov_per_iter"):
        if structure[key] != twin["structure"][key]:
            raise AssertionError(f"fm-cavity {key} differs from its (c,k) twin's")
    prof = profile(mesh, table, settings, 1.0, 1e-3, state, iterations=3, use_ck=False)
    return dict(ms_per_iter=1e3 * dt / 50, gap=gap, iterations=10 + 50 + 3, **prof)


#: The stored flux's divergence must equal minus the last pressure
#: solve's residual to this share of max |flux A| (f32 sums; 2.3e-7
#: measured on a 128^2 f32 cavity on the CPU).
FC_CONSERVATION_TOL = 1e-5


def phase_fm_fc_cavity(dev, twin):
    """21c, fm-fc-cavity-1M: fc-cavity-1M's numerics (the Ghia flagship:
    SIMPLE_FC, TVD_DC + UMIST, Rhie-Chow, LinearWeighted) on the
    face-major step, 10 warm-up + 50 timed iterations from cold: finite;
    conservative, as SIMPLE_FC is by construction: the stored flux's
    divergence equals minus the last pressure solve's residual b - A p
    (to FC_CONSERVATION_TOL of max |flux A|). Every pressure solve here
    stops at the BiCGSTAB(50) cap, and the residual it leaves varies
    2-3x from one iteration to the next, so the residual is held over the
    50 timed iterations: the median pressure residual within twice the
    (c,k) twin's (phase 7); max |div flux| / max |flux A| at the end is
    printed beside the twin's."""
    log("== phase 21c: fm-fc-cavity-1M 1024^2 f32, Ghia flagship numerics, face-major step")
    from orc_tpu_torch.models.cavity import cavity_case, flagship_settings

    settings = flagship_settings()
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, 1e-3, None, 10, 10, False)
    with LastPressureSolve() as solve:
        state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-3, state, 50, 50, False)
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.isfinite(state.flux.cpu().numpy()).all()):
        raise AssertionError("fm-fc-cavity fields not finite")
    div, scale = _face_flux_divergence(mesh, state.flux)
    cf = mesh.cell_faces.long()
    fa = mesh.cell_face_sign * state.flux[cf] * mesh.face_area[cf]
    fa = torch.where(mesh.cell_face_mask, fa, torch.zeros((), dtype=fa.dtype, device=fa.device))
    gap = float((fa.sum(dim=1) + solve.residual()).abs().max()) / scale  # rho = 1
    log(
        f"  warm-up 10 iterations {warm_s:.2f} s; 50 timed iterations {dt:.3f} s "
        f"-> {1e3 * dt / 50:.2f} ms/iter; |u| max {np.abs(u).max():.3f}; "
        f"mean pressure iterations {hist[-1].pc_iters.float().mean().item():.2f}"
    )
    pc_res = float(np.median(np.concatenate([h.pc_residual.cpu().numpy() for h in hist])))
    log(
        f"  max |div flux| / max |flux A| = {div / scale:.3e} ((c,k) twin "
        f"{twin['div_ratio']:.3e}); div flux + pressure residual: {gap:.3e} of max "
        f"|flux A| (limit {FC_CONSERVATION_TOL:.0e}); median pressure residual "
        f"{pc_res:.3e} ((c,k) twin {twin['pc_residual_median']:.3e}, limit twice that)"
    )
    if not gap <= FC_CONSERVATION_TOL:
        raise AssertionError("fm-fc-cavity flux divergence is not the pressure solve's residual")
    if not pc_res <= 2.0 * twin["pc_residual_median"]:
        raise AssertionError("fm-fc-cavity pressure solves left more residual than its (c,k) twin's")
    prof = profile(mesh, table, settings, 1.0, 1e-3, state, iterations=3, use_ck=False)
    return dict(ms_per_iter=1e3 * dt / 50, iterations=10 + 50 + 3, **prof)


def phase_ggnode(dev, n=448):
    """21d, ggnode-448: the 448^2 cavity written with write_tgrid, its
    cells relabelled (permuted_tgrid) and read with read_mesh(nodes=True)
    in f32: RCM order, slice plan and vertex tables. Irregular-448's
    numerics (forced SIMPLE, UD + LinearWeighted pressure, implicit 0.7 /
    0.1) with node-based Green-Gauss and Rhie-Chow face fluxes, whose
    pressure gradient the vertex tables feed (under LinearWeighted fluxes
    the step would read no gradient), under use_ck="auto", which takes the
    face-major step: 5 warm-up + 25 timed iterations, finite, |u| < 2."""
    log("== phase 21d: ggnode-448 f32, TGRID with relabelled cells, GG node, face-major step")
    from orc_tpu_torch.mesh.geometry import derive_geometry
    from orc_tpu_torch.mesh.nodes import build_node_interp
    from orc_tpu_torch.mesh.tgrid import parse_tgrid
    from orc_tpu_torch.utils.settings import GradientReconstruction, VelocityInterpolation

    mesh, table, read_s = gg_node_tgrid(n, dev, torch.float32, permuted=True)
    with open(smoke_dir() / f"cavity{n}-permuted.msh") as f:
        raw = parse_tgrid(f.read())
    t0 = time.perf_counter()
    build_node_interp(raw, derive_geometry(raw).cell_centroid, torch.float32, device=dev)
    nodes_s = time.perf_counter() - t0
    log(
        f"  read_mesh(nodes=True) {read_s:.2f} s, of which the vertex tables "
        f"{nodes_s:.2f} s (build_node_interp alone); {plan_line(mesh)}"
    )
    if mesh.slice_plan is None or mesh.nodes is None:
        raise AssertionError("the relabelled TGRID cavity has no slice plan or vertex tables")
    settings = bench_irregular_settings().replace(
        gradient_reconstruction=GradientReconstruction.GREEN_GAUSS_NODE,
        velocity_interpolation=VelocityInterpolation.RHIE_CHOW,
    )
    with CkGeometryBuilds() as builds:
        state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, 1e-3, None, 5, 5)
        state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-3, state, 25, 25)
    if builds.calls:
        raise AssertionError("GG node under use_ck='auto' took the (c,k) step")
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.abs(u).max() < 2.0):
        raise AssertionError("ggnode-448 fields not finite or |u| >= 2")
    log(
        f"  warm-up 5 iterations {warm_s:.2f} s; 25 timed iterations {dt:.3f} s "
        f"-> {1e3 * dt / 25:.2f} ms/iter; |u| max {np.abs(u).max():.3f}; pressure "
        f"iterations {hist[-1].pc_iters.float().mean().item():.2f}"
    )
    prof = profile(mesh, table, settings, 1.0, 1e-3, state, iterations=3)
    return dict(
        ms_per_iter=1e3 * dt / 25, read_s=read_s, nodes_s=nodes_s, iterations=5 + 25 + 3,
        **prof,
    )


def phase_fm_auto_216(dev, n=216):
    """21e, fm-auto-216: the 216^3 f32 cavity (10,077,696 cells, the first
    cube above CK_AUTO_MAX_CELLS) at Re 100, solve_cavity's numerics
    (UD + LinearWeighted, SIMPLE, BiCGSTAB(50) pressure, the 6-sweep
    smoother, which marches along z), under use_ck="auto": no CKGeometry
    is built; 3 warm-up + 5 timed iterations, finite fields; the mesh
    build seconds and the card's peak memory."""
    log("== phase 21e: fm-auto-216 216^3 f32 cavity, Re 100, use_ck='auto' above CK_AUTO_MAX_CELLS")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings
    from orc_tpu_torch.solver.simple import CK_AUTO_MAX_CELLS

    t0 = time.perf_counter()
    mesh, table = cavity_case(n=n, nz=n, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"  mesh build {build_s:.2f} s; {mesh.n_cells} cells (CK_AUTO_MAX_CELLS {CK_AUTO_MAX_CELLS})")
    if not mesh.n_cells > CK_AUTO_MAX_CELLS:
        raise AssertionError("the 216^3 cavity is not above CK_AUTO_MAX_CELLS")
    settings = default_settings()
    torch.cuda.reset_peak_memory_stats(dev)
    with CkGeometryBuilds() as builds:
        state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, 1e-2, None, 3, 3)
        state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-2, state, 5, 5)
    if builds.calls:
        raise AssertionError("use_ck='auto' above CK_AUTO_MAX_CELLS built a CKGeometry")
    peak = torch.cuda.max_memory_allocated(dev)
    u = state.vel.cpu().numpy()
    if not (np.isfinite(u).all() and np.abs(u).max() < 2.0):
        raise AssertionError("fm-auto-216 fields not finite or |u| >= 2")
    log(
        f"  warm-up 3 iterations {warm_s:.2f} s; 5 timed iterations {dt:.3f} s "
        f"-> {1e3 * dt / 5:.1f} ms/iter; peak memory allocated "
        f"{peak / 2**30:.2f} GiB; |u| max {np.abs(u).max():.3f}; pressure "
        f"iterations {hist[-1].pc_iters.float().mean().item():.2f}"
    )
    prof = profile(mesh, table, settings, 1.0, 1e-2, state, iterations=1)
    return dict(
        ms_per_iter=1e3 * dt / 5, build_s=build_s, peak_gib=peak / 2**30,
        iterations=3 + 5 + 1, **prof,
    )


# --- slice 13: algebraic multigrid, Gauss-Seidel, initialisation --------


def timed_extras(mesh, table, mu, settings):
    """(solver extras, seconds): what solve_steady builds once for
    `settings` (the multigrid hierarchy under MULTIGRID, from the
    diffusion system it aggregates on; the colouring under
    GAUSS_SEIDEL), timed on the host."""
    from orc_tpu_torch.ops.assembly import diffusion_system
    from orc_tpu_torch.ops.fields import device_bc, face_bc
    from orc_tpu_torch.solver.simple import _solver_extras

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zc, zs, zv = device_bc(table, mesh.dtype, device=mesh.device)
    diff = diffusion_system(
        mesh, face_bc(mesh, zc, zs, zv), torch.tensor(mu, dtype=mesh.dtype, device=mesh.device)
    )
    extras = _solver_extras(mesh, diff, settings)
    torch.cuda.synchronize()
    return extras, time.perf_counter() - t0


def level_form(level):
    """How a coarse level's SpMV runs: kernel 7 over its slice plan, or
    the gather form where the 128-row plan would be degenerate."""
    p = level.plan
    if p is None:
        return "gather (128-row plan degenerate: more distinct deltas a tile than rows)"
    nj = p.tile_nj.double()
    return (
        f"slice plan (kernel 7): tile {p.tile}, ntiles {p.ntiles}, n_max {p.n_max}, "
        f"mean tile_nj {float(nj.mean()):.2f}, gather table built: {p.col_tile is not None}"
    )


class PrebuiltExtras:
    """Hands `extras` (a colouring or a multigrid hierarchy, built and
    timed beforehand) to every solve_steady call while installed, so
    that timed iterations leave out the host build that each call
    repeats."""

    def __init__(self, extras):
        self.extras = extras

    def __enter__(self):
        from orc_tpu_torch.solver import simple

        self.mod, self.real = simple, simple._solver_extras
        simple._solver_extras = lambda *a, **k: self.extras
        return self

    def __exit__(self, *exc):
        self.mod._solver_extras = self.real


def amg_settings():
    """irregular-448's numerics with MULTIGRID on the pressure system at
    the solver settings' defaults (3 levels, STRONGEST, coarsest 16,
    smoother iterations = iterations)."""
    from orc_tpu_torch.utils.settings import SolutionMethod

    base = bench_irregular_settings()
    return base.replace(
        matrix_solver=dataclasses.replace(base.matrix_solver, solver_type=SolutionMethod.MULTIGRID)
    )


def gs_settings(base):
    """`base` with its pressure solved by GAUSS_SEIDEL (its iterations and
    relaxation, the greedy colouring)."""
    from orc_tpu_torch.utils.settings import SolutionMethod

    return base.replace(
        matrix_solver=dataclasses.replace(base.matrix_solver, solver_type=SolutionMethod.GAUSS_SEIDEL)
    )


def phase_amg_coarse_kernels(dev, kern):
    """Kernel 7 on the algebraic multigrid's coarse plans of the permuted
    448^2 f32 cavity (phase 22a's hierarchy): the Galerkin matrices of a
    seeded diagonally dominant system over the fine sparsity, level by
    level, each prepared on its plan and Jacobi-scaled, against the plain
    version, with the CSR product and the bound. Levels without a plan
    gather."""
    log("== phase 3: kernel 7 on the algebraic multigrid's coarse plans, permuted cavity 448^2 f32")
    from orc_tpu_torch.ops.slice_spmv import slice_spmv, slice_spmv_plain
    from orc_tpu_torch.ops.spmv import EllMatrix
    from orc_tpu_torch.solver.amg import galerkin_values

    mesh, table, _ = permuted_cavity(448, torch.float32, dev)
    extras, secs = timed_extras(mesh, table, 1e-3, amg_settings())
    levels = extras["mg_hierarchy"]
    log(f"  hierarchy of {len(levels)} levels built on the host in {secs:.2f} s")
    interior = _interior(mesh)
    C, K = interior.shape
    rng = np.random.default_rng(0)
    off = -torch.tensor(rng.uniform(0.0, 1.0, (C, K)), dtype=torch.float32, device=dev) * interior
    diag = 1.0 + off.abs().sum(dim=1) + torch.tensor(rng.random(C), dtype=torch.float32, device=dev)
    A = EllMatrix(diag, off, mesh.cell_neighbors)
    timed = True
    for i, level in enumerate(levels, 1):
        A = galerkin_values(A, level)
        log(f"  level {i}: n_c {level.n_coarse}, K_c {level.k_coarse}; {level_form(level)}")
        plan = level.plan
        if plan is None:
            continue
        Ap, _ = A.prepare().jacobi_preconditioned()
        n = level.n_coarse
        nj = plan.tile_nj.long()
        t_rows = torch.clamp(n - torch.arange(plan.ntiles, device=dev) * plan.tile, max=plan.tile)
        used = int((nj * t_rows).sum())
        x = torch.tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
        kern.compare(
            f"amg level {i} ({n} rows) B=1",
            lambda: slice_spmv(Ap.diag, Ap.off, plan, x),
            lambda: slice_spmv_plain(Ap.diag, Ap.off, plan, x),
            torch.float32, 4 * (used + 3 * n) + plan.ntiles * 4 * (1 + plan.n_max),
            timed=timed, nops=2 * (used + n),
            library_call=plan_csr_call(Ap.diag, Ap.off, plan, x),
        )
        timed = False
    if timed:
        raise AssertionError("no coarse level of the permuted 448^2 cavity has a slice plan")


def _recovery_case(d):
    """tests/test_aux.py::test_recovery_backs_off_and_completes: the 4x4
    channel at dp/dx = 500 with an over-relaxed Jacobi solver on every
    solve, which diverges until the relaxation is backed off."""
    from orc_tpu_torch.models.channel_flow import ChannelFlowParameters, couette_case
    from orc_tpu_torch.utils.settings import (
        MatrixSolverSettings,
        MomentumScheme,
        NumericalSettings,
        PressureInterpolation,
        SolutionMethod,
        VelocityInterpolation,
    )

    settings = NumericalSettings(
        momentum=MomentumScheme.UD,
        pressure_interpolation=PressureInterpolation.LINEAR_WEIGHTED,
        velocity_interpolation=VelocityInterpolation.LINEAR_WEIGHTED,
        matrix_solver=MatrixSolverSettings(
            solver_type=SolutionMethod.JACOBI, iterations=4, relaxation=1.9,
            momentum_iterations=None,
        ),
        pressure_relaxation=0.5,
        momentum_relaxation=1.0,
    )
    mesh, table = couette_case(4, 4, params=ChannelFlowParameters(dp_dx=500.0), device=d)
    return mesh, table, settings


def phase_small_reference_solvers(dev):
    """Phase 3b for slice 13, card against CPU, float64: the permuted 16^2
    cavity under MULTIGRID (the algebraic hierarchy) and the 16^2 cavity
    under GAUSS_SEIDEL, 10 iterations each (equal inner counts, fields to
    1e-9 of scale); initialize_flow on the 64x32 velocity-inlet channel
    (1e-9); solve_steady_with_recovery on tests/test_aux.py:73's case (the
    same recovery log, finite fields, the card's within 1e-9 of the
    CPU's)."""
    log("== phase 3b: AMG, Gauss-Seidel, initialisation and recovery on the card vs on the CPU, f64")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings
    from orc_tpu_torch.solver.amg import MgLevel
    from orc_tpu_torch.solver.init_fields import initialize_flow
    from orc_tpu_torch.solver.recovery import solve_steady_with_recovery
    from orc_tpu_torch.solver.simple import solve_steady, stack_history

    amg = default_settings().replace(matrix_solver=mg_settings(3, 5))
    box, table = cavity_case(n=16, device="cpu")
    mesh, _ = permuted_mesh(box, torch.float64, dev, seed=3)
    levels = timed_extras(mesh, table, 0.01, amg)[0]["mg_hierarchy"]
    if not (levels and all(isinstance(lv, MgLevel) for lv in levels)):
        raise AssertionError("the permuted 16^2 cavity did not get the algebraic hierarchy")
    log("  permuted 16^2 levels: " + "; ".join(
        f"n_c {lv.n_coarse} {'slice plan' if lv.plan is not None else 'gather'}" for lv in levels
    ))
    _card_cpu_gap("permuted MULTIGRID (AMG)", _irregular_twins(dev, amg, 10), 1e-9)
    gs = gs_settings(default_settings())
    out = []
    for d in (dev, torch.device("cpu")):
        m, t = cavity_case(n=16, device=d)
        state, hist = solve_steady(m, t, gs, 1.0, 0.01, iterations=10, reporting_interval=10, verbose=False)
        out.append((state, stack_history(hist)))
    _card_cpu_gap("structured GAUSS_SEIDEL", out, 1e-9)
    states = [initialize_flow(*rans_channel(d, 64, 32, torch.float64), 1e-5, 1.0)
              for d in (dev, torch.device("cpu"))]
    errs = {n: max_err(getattr(states[0], n).cpu(), getattr(states[1], n))[1][0] for n in ("vel", "p")}
    log(f"  initialize_flow, channel 64x32: error / scale vel {errs['vel']:.3e} p {errs['p']:.3e} (tol 1e-9)")
    if not all(e <= 1e-9 for e in errs.values()):
        raise AssertionError("initialize_flow on the card left the CPU's")
    runs = []
    for d in (dev, torch.device("cpu")):
        m, t, settings = _recovery_case(d)
        runs.append(solve_steady_with_recovery(
            m, t, settings, 1000.0, 0.001, iterations=40, reporting_interval=10,
            max_retries=5, verbose=False,
        ))
    (sg, _, log_g), (sc, _, log_c) = runs
    gap = max_err(sg.vel.cpu(), sc.vel)[1][0]
    log(f"  recovery: card log {log_g}; the same as the CPU's: {log_g == log_c}; vel gap {gap:.3e} of scale")
    if not (log_g == log_c and log_g and np.isfinite(sg.vel.cpu().numpy()).all() and gap <= 1e-9):
        raise AssertionError("solve_steady_with_recovery on the card left the CPU's")


def phase_amg_448(dev):
    """22a, amg-448: the permuted 448^2 f32 cavity (irregular-448) with
    MULTIGRID on the pressure system, the algebraic hierarchy at the
    settings' defaults; 5 warm-up + 25 timed iterations beside its
    BiCGSTAB(50) twin from the same run. The host build of the hierarchy
    is timed alone and left out of the iterations. Finite fields, |u| <
    2."""
    log("== phase 22a: amg-448, permuted cavity 448^2 f32, MULTIGRID (algebraic hierarchy, 3 levels, STRONGEST)")
    t_start = time.perf_counter()
    mesh, table, _ = permuted_cavity(448, torch.float32, dev)
    out = {}
    for name, settings in (("MULTIGRID", amg_settings()), ("BiCGSTAB(50)", bench_irregular_settings())):
        extras, build_s = timed_extras(mesh, table, 1e-3, settings)
        if name == "MULTIGRID":
            log(f"  hierarchy built on the host in {build_s:.2f} s")
            for i, lv in enumerate(extras["mg_hierarchy"], 1):
                log(f"  level {i}: n_c {lv.n_coarse}, K_c {lv.k_coarse}; {level_form(lv)}")
        with PrebuiltExtras(extras):
            state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, 1e-3, None, 5, 5)
            state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-3, state, 25, 25)
            u = state.vel.cpu().numpy()
            if not (np.isfinite(u).all() and np.isfinite(state.p.cpu().numpy()).all() and np.abs(u).max() < 2.0):
                raise AssertionError(f"amg-448 {name}: fields not finite or |u| >= 2")
            h = hist[-1]
            res = dict(
                ms_per_iter=1e3 * dt / 25, pc_iters=h.pc_iters.float().mean().item(),
                pc_residual=h.pc_residual[-1].item(), build_s=build_s,
            )
            log(
                f"  {name}: warm-up 5 iterations {warm_s:.2f} s; 25 timed iterations {dt:.3f} s "
                f"-> {res['ms_per_iter']:.2f} ms/iter; mean pressure iterations "
                f"{res['pc_iters']:.2f}; pressure residual after iteration 30 "
                f"{res['pc_residual']:.3e}; |u| max {np.abs(u).max():.3f}"
            )
            res.update(profile(mesh, table, settings, 1.0, 1e-3, state, iterations=2))
        out[name] = res
    out["seconds"] = time.perf_counter() - t_start
    return out


def phase_gs_cavity(dev, twin):
    """22b, gs-cavity-1M: cavity-1M's numerics (solve_cavity's) with the
    pressure solved by GAUSS_SEIDEL(50) over the greedy colouring (built
    and timed alone), 10 warm-up + 50 timed iterations: finite, |u| < 2;
    the median pressure residual beside cavity-1M's (phase 5)."""
    log("== phase 22b: gs-cavity-1M 1024^2 f32, solve_cavity configuration, GAUSS_SEIDEL(50) pressure")
    from orc_tpu_torch.models.cavity import cavity_case, default_settings

    t_start = time.perf_counter()
    settings = gs_settings(default_settings())
    mesh, table = cavity_case(n=1024, dtype=torch.float32, device=dev)
    extras, color_s = timed_extras(mesh, table, 1e-3, settings)
    log(f"  greedy colouring of {mesh.n_cells} cells on the host in {color_s:.2f} s: {extras['n_colors']} colours")
    with PrebuiltExtras(extras):
        state, _, warm_s = _timed_solve(mesh, table, settings, 1.0, 1e-3, None, 10, 10)
        state, hist, dt = _timed_solve(mesh, table, settings, 1.0, 1e-3, state, 50, 50)
        u = state.vel.cpu().numpy()
        if not (np.isfinite(u).all() and np.abs(u).max() < 2.0):
            raise AssertionError("gs-cavity-1M fields not finite or |u| >= 2")
        pc_res = float(np.median(np.concatenate([h.pc_residual.cpu().numpy() for h in hist])))
        log(
            f"  warm-up 10 iterations {warm_s:.2f} s; 50 timed iterations {dt:.3f} s -> "
            f"{1e3 * dt / 50:.2f} ms/iter (cavity-1M, BiCGSTAB(50): {twin['ms_per_iter']:.2f}); "
            f"median pressure residual {pc_res:.3e} (cavity-1M {twin['pc_residual_median']:.3e}); "
            f"|u| max {np.abs(u).max():.3f}"
        )
        prof = profile(mesh, table, settings, 1.0, 1e-3, state, iterations=3)
    return dict(
        ms_per_iter=1e3 * dt / 50, n_colors=extras["n_colors"], color_s=color_s,
        pc_residual_median=pc_res, seconds=time.perf_counter() - t_start, **prof,
    )


#: initialize_flow's mass balance at the inlet: the first cell column's
#: mean u within this share of the inlet velocity (the tolerance of
#: tests/test_channel_flow.py's inlet tests).
INIT_INLET_TOL = 0.05
#: The card's initial fields against the CPU's (f32, sums in another
#: order over ten Krylov iterations), share of each field's scale.
INIT_CARD_CPU_TOL = 1e-4


def phase_init_channel(dev, nx=1024, ny=512):
    """22c, init-channel: initialize_flow on rans-channel's 1024x512x1 f32
    box (velocity inlet 1): its seconds; finite fields; the inlet column
    carries the inlet's mass flow (INIT_INLET_TOL); the card's fields
    against the port's CPU run on the same mesh (INIT_CARD_CPU_TOL). The
    potential-flow solve takes orc_tpu's ten BiCGSTAB iterations, which
    reach a few tens of cells from the inlet, so the bulk velocity is
    far below the inlet's (in orc_tpu too); it is printed, not held."""
    log("== phase 22c: init-channel, initialize_flow on the 1024x512 f32 channel, velocity inlet 1")
    from orc_tpu_torch.solver.init_fields import initialize_flow

    t_start = time.perf_counter()
    mesh, table = rans_channel(dev, nx, ny, torch.float32)
    initialize_flow(mesh, table, 1e-5, 1.0)  # the first call's one-time work
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = initialize_flow(mesh, table, 1e-5, 1.0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cpu = initialize_flow(*rans_channel("cpu", nx, ny, torch.float32), 1e-5, 1.0)
    u = state.vel[:, 0].cpu().numpy().reshape(ny, nx)
    inlet, outlet = float(u[:, 0].mean()), float(u[:, -1].mean())
    errs = {n: max_err(getattr(state, n).cpu(), getattr(cpu, n))[1][0] for n in ("vel", "p")}
    log(
        f"  initialize_flow {1e3 * secs:.2f} ms; inlet column mean u {inlet:.5f} (inlet 1, tol "
        f"{INIT_INLET_TOL}); outlet column {outlet:.3e}; u_mean {float(u.mean()):.5f}; "
        f"card vs CPU error / scale vel {errs['vel']:.3e} p {errs['p']:.3e} (tol {INIT_CARD_CPU_TOL:.0e})"
    )
    finite = bool(np.isfinite(state.vel.cpu().numpy()).all() and np.isfinite(state.p.cpu().numpy()).all())
    if not (finite and abs(inlet - 1.0) < INIT_INLET_TOL):
        raise AssertionError("init-channel: fields not finite or the inlet column's mass flow is off")
    if not all(e <= INIT_CARD_CPU_TOL for e in errs.values()):
        raise AssertionError("init-channel: the card's initial fields left the CPU's")
    return dict(ms=1e3 * secs, u_mean=float(u.mean()), seconds=time.perf_counter() - t_start)


def phase_channel_128(dev):
    """22d, channel-128x64: solve_channel_flow at the reference's largest
    mesh (128x64, f64) with default NumericalSettings (MULTIGRID, which
    takes the geometric hierarchy on this box) and the reference's
    validated parameters (moving top wall 5e-4, dp/dx 10), 100
    iterations from initialize_flow: ms/iter of the whole call, the
    statistics; result["passed"]; a profile window of one iteration."""
    log("== phase 22d: channel-128x64, solve_channel_flow f64, default numerics (MULTIGRID), 100 iterations")
    from orc_tpu_torch.models.channel_flow import ChannelFlowParameters, solve_channel_flow
    from orc_tpu_torch.utils.settings import NumericalSettings

    t_start = time.perf_counter()
    params = ChannelFlowParameters(top_wall_velocity=5e-4, dp_dx=10.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solve_channel_flow(params, nx=128, ny=64, iterations=100, reporting_interval=100,
                           verbose=False, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stats = {k: v for k, v in r.items() if isinstance(v, float)}
    log(f"  100 iterations (with mesh build and initialize_flow) {dt:.3f} s -> {1e3 * dt / 100:.2f} ms/iter")
    log("  " + ", ".join(f"{k} {v:.6e}" for k, v in stats.items()))
    log(f"  mean_ok {r['mean_ok']} min_ok {r['min_ok']} max_ok {r['max_ok']}: passed {r['passed']}")
    if not r["passed"]:
        raise AssertionError("solve_channel_flow 128x64 did not pass its validation")
    prof = profile(r["mesh"], r["table"], NumericalSettings(), params.rho, params.mu, r["state"], iterations=1)
    return dict(ms_per_iter=1e3 * dt / 100, passed=r["passed"], seconds=time.perf_counter() - t_start, **prof)


# --- phase 23: the CLI ----------------------------------------------------

#: The example case files, each run through the CLI at its own mesh size.
EXAMPLES = (
    "cavity", "cavity_3d", "cavity_sequenced", "channel_flow_velocity_inlet",
    "couette_flow", "periodic_channel", "transient_startup", "turbulent_channel",
)
#: Bulk velocity each channel example's run must reach in sign and order
#: of magnitude (within a factor CLI_U_MEAN_FACTOR either way): the
#: velocity inlet's 1e-3 and the couette's analytical u_mean.
CLI_U_MEAN_REF = {
    "channel_flow_velocity_inlet": 1e-3,
    "couette_flow": ANALYTICAL_U_MEAN,
}
CLI_U_MEAN_FACTOR = 10.0
#: The CLI's ms/iter on the 1024^2 case may exceed the same solve called
#: in this process by this share at most: the CLI adds no per-iteration
#: cost, and host noise moves either by a few percent.
CLI_OVERHEAD_TOL = 0.10
#: CLI runs of cli-1M, each between two in-process runs: the host's speed
#: wanders between about 42 and 75 ms/iter over seconds in either path
#: (a run lasts 3-8 s), and with two CLI runs both of them landed in its
#: slow spells while the three in-process runs did not (ratio 1.363).
CLI_TURNS = 4
#: Card against CPU through the CLI (float64 checkpoints), share of
#: each field's scale.
CLI_CARD_CPU_TOL = 1e-9


def case_copy(text, out_dir, iterations=None, steps=None, inner=None,
              cap=None, dims=None, levels=None, mesh=None, checkpoint=True,
              data=True, reporting=None):
    """The text of a case file with its run cut and its outputs moved into
    `out_dir`: [case] iterations and [case.sequencing]
    iterations_per_level at most `iterations`, [case] reporting_interval
    set to `reporting`; [time] steps and
    inner_iterations at most `steps` and `inner`; each [case.generate]
    dim at most `cap`, or set to `dims` (nx, ny, nz); [case.sequencing]
    levels set to `levels`; data_file (dropped unless `data`),
    gradients_file and vtk_file moved into out_dir; checkpoint_file
    out_dir/checkpoint.npz when `checkpoint`; `mesh` in place of the
    [case.generate] table. Every other line is kept as it is."""
    import os
    import tomllib

    def at_most(value, limit):
        return value if limit is None else min(value, limit)

    out_dir = str(out_dir)
    lines, table = [], None
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("["):
            table = s.strip("[]").strip()
            if not (mesh is not None and table == "case.generate"):
                lines.append(line)
            if table == "case":
                if mesh is not None:
                    lines.append(f"mesh = {json.dumps(str(mesh))}")
                if checkpoint:
                    ckpt = os.path.join(out_dir, "checkpoint.npz")
                    lines.append(f"checkpoint_file = {json.dumps(ckpt)}")
            continue
        if mesh is not None and table == "case.generate":
            continue
        if "=" not in s or s.startswith("#"):
            lines.append(line)
            continue
        key, value = next(iter(tomllib.loads(s).items()))
        new = value
        if table == "case.generate" and key in ("nx", "ny", "nz"):
            new = at_most(value, cap) if dims is None else dims["xyz".index(key[1])]
        elif table == "case" and key == "iterations":
            new = at_most(value, iterations)
        elif table == "case" and key == "reporting_interval" and reporting is not None:
            new = reporting
        elif table == "case" and key in ("data_file", "gradients_file", "vtk_file", "checkpoint_file"):
            if (key == "data_file" and not data) or (key == "checkpoint_file" and checkpoint):
                continue
            new = os.path.join(out_dir, os.path.basename(value))
        elif table == "case" and key == "mesh" and mesh is not None:
            continue
        elif table == "case.sequencing" and key == "iterations_per_level":
            new = at_most(value, iterations)
        elif table == "case.sequencing" and key == "levels" and levels is not None:
            new = levels
        elif table == "time" and key == "steps":
            new = at_most(value, steps)
        elif table == "time" and key == "inner_iterations":
            new = at_most(value, inner)
        lines.append(line if new == value else f"{key} = {json.dumps(new)}")
    return "\n".join(lines) + "\n"


def run_cli(argv):
    """orc_tpu_torch.cli.main(argv) in this process (no interpreter start,
    no kernel rebuild), its standard output captured: (output, seconds).
    Raises when it fails, after logging the output's tail."""
    import contextlib
    import io

    from orc_tpu_torch.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main([str(a) for a in argv])
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    except BaseException:
        log("  CLI output before the failure:\n" + buf.getvalue()[-4000:])
        raise
    if rc != 0:
        log(buf.getvalue()[-4000:])
        raise AssertionError(f"cli {' '.join(map(str, argv))} exited {rc}")
    return buf.getvalue(), time.perf_counter() - t0


def chunk_ms(output):
    """The ms/iter of each chunk solve_steady reported in a run's output
    (its own clock, synchronised, setup excluded)."""
    found = [float(x) for x in re.findall(r"ms/iter = ([0-9.eE+-]+)", output)]
    if not found:
        raise AssertionError("the run reported no ms/iter")
    return found


def read_back(case_path, history=None, vtk=None):
    """Read back every file a CLI run of `case_path` wrote and check the
    fields are finite: returns {"cells", "u_mean"} of its data file."""
    from orc_tpu_torch.io.data import read_data
    from orc_tpu_torch.io.vtk import read_vtk_cell_data
    from orc_tpu_torch.utils.config import load_case

    case = load_case(str(case_path))
    got = {}
    if case.data_file:
        vel, p = read_data(case.data_file)
        if not (np.isfinite(vel).all() and np.isfinite(p).all()):
            raise AssertionError(f"{case.data_file}: non-finite fields")
        got = dict(cells=vel.shape[0], u_mean=float(vel[:, 0].mean()))
    if case.gradients_file:
        with open(case.gradients_file) as f:
            rows = [re.findall(r"[-0-9.e]+", line) for line in f]
        g = np.array(rows, dtype=np.float64)
        if g.shape[1] != 15 or not np.isfinite(g).all() or g.shape[0] != got.get("cells", g.shape[0]):
            raise AssertionError(f"{case.gradients_file}: bad rows {g.shape}")
    if case.checkpoint_file:
        with np.load(case.checkpoint_file) as z:
            for key in ("vel", "p", "mom_diag"):
                if not np.isfinite(z[key]).all():
                    raise AssertionError(f"{case.checkpoint_file}: non-finite {key}")
    if history:
        with np.load(history) as z:
            if z["diverged"].any() or not np.isfinite(z["vel_avg"]).all():
                raise AssertionError(f"{history}: diverged")
    if vtk:
        f = read_vtk_cell_data(str(vtk))
        if not (np.isfinite(f["velocity"]).all() and np.isfinite(f["pressure"]).all()):
            raise AssertionError(f"{vtk}: non-finite fields")
        if got and f["pressure"].shape[0] != got["cells"]:
            raise AssertionError(f"{vtk}: {f['pressure'].shape[0]} cells")
    return got


def launch_counts(kernels):
    return {k.name: getattr(k.fn, k.counter) for k in kernels}


def launched_since(kernels, before):
    """{kernel: launches} since `before` (launch_counts), nonzero only."""
    now = launch_counts(kernels)
    return {n: now[n] - before[n] for n in now if now[n] != before[n]}


def cli_dir(*parts):
    """An empty directory build/chip_smoke/cli/<parts> (earlier runs'
    checkpoints would be resumed)."""
    path = smoke_dir().joinpath("cli", *parts)
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def npz(path):
    """The arrays of an npz archive, read and closed."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _u_residuals(history):
    """The u-momentum solve's final residual at the first and the last
    iteration of a run's history."""
    with np.load(history) as z:
        mom = z["mom_residual"].reshape(-1, 3)[:, 0]
    return mom[0], mom[-1]


def _log_gap(a, b):
    return abs(np.log10(max(float(a), 1e-300)) - np.log10(max(float(b), 1e-300)))


def phase_cli_examples(dev, kernels, examples_dir, iterations=20, steps=2):
    """23a: every examples/*.toml through `run` at its own mesh size,
    [case] iterations and iterations_per_level capped at `iterations`,
    [time] steps at `steps`, outputs in build/chip_smoke/cli/<case>/,
    each with a checkpoint and --history, couette_flow also with --vtk;
    every file read back. Returns {case: (case path, out dir, result)}."""
    from orc_tpu_torch.ops.fused_smooth import fused_jacobi_sweeps

    runs = {}
    for name in EXAMPLES:
        out = cli_dir(name)
        case = out / "case.toml"
        case.write_text(case_copy(
            (examples_dir / f"{name}.toml").read_text(), out,
            iterations=iterations, steps=steps,
        ))
        hist = out / "history.npz"
        vtk = out / "solution.vtk" if name == "couette_flow" else None
        before = launch_counts(kernels)
        inst0 = dict(fused_jacobi_sweeps.instances)
        argv = ["run", case, "--history", hist, "--device", dev]
        if vtk:
            argv += ["--vtk", vtk]
        text, secs = run_cli(argv)
        got = read_back(case, history=hist, vtk=vtk)
        mesh_line = next(line for line in text.splitlines() if line.startswith("mesh:"))
        ms = re.findall(r"ms/iter = ([0-9.eE+-]+)", text)
        log(
            f"  {name:28s} {secs:6.2f} s  {mesh_line[6:]}; u_mean {got['u_mean']:.4e}; "
            f"solver ms/iter {ms[-1] if ms else '-'}; launched {launched_since(kernels, before)}"
        )
        inst = {k: v - inst0.get(k, 0) for k, v in fused_jacobi_sweeps.instances.items()
                if v != inst0.get(k, 0)}
        if inst:
            log(f"    fused_jacobi_sweeps instances (calls): {inst}")
        ref = CLI_U_MEAN_REF.get(name)
        if ref is not None and not (1 / CLI_U_MEAN_FACTOR < got["u_mean"] / ref < CLI_U_MEAN_FACTOR):
            raise AssertionError(f"{name}: u_mean {got['u_mean']:.3e} is not of the order of {ref:.3e}")
        if name in ("periodic_channel", "turbulent_channel") and not got["u_mean"] > 0:
            raise AssertionError(f"{name}: the body force drove no positive flow")
        runs[name] = (case, out, dict(got, seconds=secs))
    return runs


def phase_cli_resume(dev, runs, iterations=3):
    """23b: couette_flow and turbulent_channel again from the checkpoints
    23a wrote (a case copy naming no data file, so the run starts from
    the checkpoint; turbulent_channel's k/eps/mu_t come from it too): the
    resumed run's first u-momentum residual lies nearer (in log10) the
    first run's last one than the first run's first one did. (The
    pressure solve's final residual is no measure of progress: BiCGSTAB
    stops at its relative threshold, so on the couette it stays flat.)"""
    from orc_tpu_torch.utils.config import load_case

    for name in ("couette_flow", "turbulent_channel"):
        case, out, _ = runs[name]
        fresh, last = _u_residuals(out / "history.npz")
        resume = out / "resume.toml"
        resume.write_text(case_copy(case.read_text(), out, iterations=iterations, data=False))
        if not load_case(str(resume)).checkpoint_file:
            raise AssertionError("the resume case names no checkpoint")
        hist = out / "resume_history.npz"
        _, secs = run_cli(["run", resume, "--history", hist, "--device", dev])
        first, _ = _u_residuals(hist)
        log(
            f"  {name}: resumed in {secs:.2f} s; u-momentum residual: first run's first "
            f"{fresh:.3e}, its last {last:.3e}, the resumed run's first {first:.3e}"
        )
        if not _log_gap(first, last) < _log_gap(fresh, last):
            raise AssertionError(f"{name}: the resumed run restarted instead of continuing")


def relabelled_cavity(out, n):
    """A TGRID n^2 cavity (cavity_case's geometry) with its cells relabelled
    by permuted_tgrid: (path, perm)."""
    from orc_tpu_torch.mesh.generate import write_tgrid

    box = out / f"cavity{n}.msh"
    write_tgrid(str(box), n, n, 1, lengths=(1.0, 1.0, 1.0 / n))
    path = out / f"cavity{n}-relabelled.msh"
    perm = permuted_tgrid(str(box), str(path), seed=5)
    box.unlink()
    return path, perm


def phase_cli_tgrid(dev, kernels, examples_dir, n, iterations=10):
    """23c: a case file whose mesh is a relabelled n^2 TGRID cavity with
    cavity.toml's numerics: the C++ reader built and timed against the
    Python parser (same RawMesh), read_mesh(native=True) onto the card
    (RCM order, slice plan); `run` with data, checkpoint and VTK; the
    data file's rows, and the VTK's, equal to the checkpoint's fields
    mapped through to_raw_order; rows 7 and 10 launched; `info`."""
    from orc_tpu_torch.io.checkpoint import load_checkpoint
    from orc_tpu_torch.io.data import read_data
    from orc_tpu_torch.io.vtk import read_vtk_cell_data
    from orc_tpu_torch.mesh import native
    from orc_tpu_torch.mesh.compile import to_raw_order
    from orc_tpu_torch.mesh.tgrid import parse_tgrid, read_mesh

    out = cli_dir("tgrid")
    path, _ = relabelled_cavity(out, n)
    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw_n = native.parse_tgrid_native(str(path))
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path) as f:
        raw_p = parse_tgrid(f.read())
    python_s = time.perf_counter() - t0
    same = (
        raw_n.n_cells == raw_p.n_cells
        and np.array_equal(raw_n.face_cells, raw_p.face_cells)
        and np.array_equal(raw_n.points, raw_p.points)
        and np.array_equal(raw_n.face_zone_id, raw_p.face_zone_id)
    )
    t0 = time.perf_counter()
    mesh, _ = read_mesh(str(path), native=True, device=dev)
    read_s = time.perf_counter() - t0
    log(
        f"  {n}^2 relabelled TGRID ({path.stat().st_size / 1e6:.1f} MB): C++ reader built/loaded "
        f"in {build_s:.2f} s, parse {native_s:.3f} s vs Python {python_s:.3f} s "
        f"({python_s / native_s:.1f}x), same RawMesh {same}; read_mesh(native=True) {read_s:.2f} s; "
        f"{plan_line(mesh)}"
    )
    if not same or mesh.cell_order is None or mesh.slice_plan is None:
        raise AssertionError("the relabelled TGRID case did not read as an irregular mesh")
    case = out / "case.toml"
    case.write_text(case_copy(
        (examples_dir / "cavity.toml").read_text(), out, iterations=iterations, mesh=path,
    ))
    vtk = out / "solution.vtk"
    before = launch_counts(kernels)
    text, secs = run_cli(["run", case, "--vtk", vtk, "--history", out / "history.npz", "--device", dev])
    launched = launched_since(kernels, before)
    got = read_back(case, history=out / "history.npz", vtk=vtk)
    state, _ = load_checkpoint(str(out / "checkpoint.npz"), mesh)
    vel_raw, p_raw = to_raw_order(mesh, state.vel), to_raw_order(mesh, state.p)
    vel_txt, p_txt = read_data(str(out / "cavity.csv"))
    fields = read_vtk_cell_data(str(vtk))
    # The text holds 7 significant digits; the VTK the float64 bits.
    txt_err = max(
        float(np.max(np.abs(vel_txt - vel_raw) / (np.abs(vel_raw) + 1e-30))),
        float(np.max(np.abs(p_txt - p_raw) / (np.abs(p_raw) + 1e-30))),
    )
    vtk_same = np.array_equal(fields["velocity"], vel_raw) and np.array_equal(fields["pressure"], p_raw)
    moved = not np.array_equal(vel_raw, state.vel.cpu().numpy())
    info, _ = run_cli(["info", path, "--device", dev])
    log(
        f"  run {secs:.2f} s ({iterations} iterations, solver {chunk_ms(text)[-1]:.3f} ms/iter); "
        f"launched {launched}; data rows vs to_raw_order(checkpoint) max rel err {txt_err:.1e} "
        f"(7 digits); VTK bitwise {vtk_same}; raw order differs from compiled {moved}"
    )
    log("  info: " + " | ".join(info.strip().splitlines()[-2:]))
    if not (txt_err < 1e-6 and vtk_same and moved):
        raise AssertionError("the relabelled case's files are not in raw order")
    for k in ("slice_spmv", "slice_nbr_values"):
        if not launched.get(k):
            raise AssertionError(f"the relabelled case launched no {k}")
    return dict(seconds=secs, parse_native_s=native_s, parse_python_s=python_s, cells=got["cells"])


class SaveCheckpointTimer:
    """Times each call of io.checkpoint.save_checkpoint (which cli.run
    imports when it runs) while installed: `seconds`."""

    def __enter__(self):
        from orc_tpu_torch.io import checkpoint

        self.mod, self.real, self.seconds = checkpoint, checkpoint.save_checkpoint, []

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = self.real(*a, **k)
            self.seconds.append(time.perf_counter() - t0)
            return out

        checkpoint.save_checkpoint = timed
        return self

    def __exit__(self, *exc):
        self.mod.save_checkpoint = self.real


def _inprocess_chunks(mesh, table, case, state, iterations, chunk):
    """chunk_ms of solve_steady run in this process, its output captured."""
    import contextlib
    import io

    from orc_tpu_torch.solver.simple import solve_steady

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        solve_steady(mesh, table, case.settings, case.rho, case.mu, state=state,
                     iterations=iterations, reporting_interval=chunk)
    return chunk_ms(buf.getvalue())


def phase_cli_1m(dev, kernels, examples_dir, twin_ms, n=1024, chunk=10, iterations=50):
    """23d: cavity.toml's numerics at n^2 = 1024^2 (float64: case files have no
    dtype key) through `run`: 10 iterations to warm up, then `iterations`
    timed in chunks of `chunk`, each run with --history and a checkpoint
    only (every timed run resumes from the warm-up's). The solve is bound
    by the host, whose speed wanders by a third within seconds, so the CLI
    and the same solve_steady called in this process from the same warm
    state take turns, each as many iterations: in process, then CLI_TURNS
    times CLI and in process. The median of the solver's own ms/iter over
    the CLI's chunks against the median over the in-process chunks: at
    most CLI_OVERHEAD_TOL above it. The seconds of the CLI's own
    save_checkpoint; the launches of the first CLI run; a profile window."""
    from orc_tpu_torch.io.checkpoint import load_checkpoint
    from orc_tpu_torch.utils.config import build_problem, load_case

    out = cli_dir("cli-1M")
    text = (examples_dir / "cavity.toml").read_text()
    warm, timed = out / "warm.toml", out / "timed.toml"
    warm.write_text(case_copy(text, out, iterations=10, dims=(n, n, 1), data=False))
    timed.write_text(case_copy(text, out, iterations=iterations, dims=(n, n, 1), data=False,
                               reporting=chunk))
    _, warm_s = run_cli(["run", warm, "--history", out / "warm.npz", "--device", dev])
    warm_ckpt = out / "warm_checkpoint.npz"
    shutil.copy(out / "checkpoint.npz", warm_ckpt)
    case = load_case(str(timed))
    mesh, table = build_problem(case, device=dev)

    def in_process():
        state, _ = load_checkpoint(str(warm_ckpt), mesh)
        return _inprocess_chunks(mesh, table, case, state, iterations, chunk)

    def cli():
        # The timed case resumes from checkpoint.npz, which each run rewrites.
        shutil.copy(warm_ckpt, out / "checkpoint.npz")
        before = launch_counts(kernels)
        with SaveCheckpointTimer() as saves:
            output, secs = run_cli(["run", timed, "--history", out / "timed.npz", "--device", dev])
        return chunk_ms(output), secs, launched_since(kernels, before), sum(saves.seconds)

    inproc_runs, cli_runs = [in_process()], []
    for _ in range(CLI_TURNS):
        cli_runs.append(cli())
        inproc_runs.append(in_process())
    cli_chunks = [ms for run in cli_runs for ms in run[0]]
    inproc_chunks = [ms for run in inproc_runs for ms in run]
    cli_ms = float(np.median(cli_chunks))
    inproc_ms = float(np.median(inproc_chunks))
    secs = [run[1] for run in cli_runs]
    launched = cli_runs[0][2]
    save_s = cli_runs[0][3]
    with np.load(out / "timed.npz") as z:
        pc_it = float(z["pc_iters"].mean())
    turns = "; ".join(
        [f"in process {inproc_runs[0]}"]
        + [f"CLI {c[0]}, in process {i}" for c, i in zip(cli_runs, inproc_runs[1:])]
    )
    log(
        f"  cli-1M ({n}^2): warm-up run {warm_s:.2f} s; timed runs {secs} s wall; solver "
        f"ms/iter by chunk of {chunk}, in turns: {turns} (medians: CLI {cli_ms:.3f}, "
        f"in process {inproc_ms:.3f}, ratio "
        f"{cli_ms / inproc_ms:.3f}); phase 5's f32 Re 1000 cavity {twin_ms:.3f}; mean "
        f"pressure iterations {pc_it:.2f}; the CLI's save_checkpoint {save_s:.3f} s "
        f"({(out / 'checkpoint.npz').stat().st_size / 1e6:.1f} MB); launched {launched} "
        f"({sum(launched.values()) / iterations:.1f} per iteration)"
    )
    state, _ = load_checkpoint(str(out / "checkpoint.npz"), mesh)
    prof = profile(mesh, table, case.settings, case.rho, case.mu, state, iterations=1)
    if not cli_ms <= (1 + CLI_OVERHEAD_TOL) * inproc_ms:
        raise AssertionError(
            f"cli-1M: the CLI's median {cli_ms:.3f} ms/iter exceeds the in-process "
            f"median {inproc_ms:.3f} by more than {CLI_OVERHEAD_TOL:.0%}"
        )
    return dict(ms_per_iter=cli_ms, inproc_ms_per_iter=inproc_ms, run_s=secs,
                save_checkpoint_s=save_s, launches=launched, **prof)


#: Phase 3's labels of the instances phase 23e holds `bench`'s extended
#: lines 1, 3 and 4 to (their (C, K) are what phase_kernels returns).
BENCH_SPMV_LABEL = "box 1024^2 f32 B=1 [C,K] (bench line 1)"
BENCH_PAIRS = {
    3: ("cavity 1024^2 f32", "cavity 1024^2 f32"),
    4: ("cavity 1024^2 f32 cd1+so+rc gg", "cavity 1024^2 f32 rc gg"),
}
#: Line 1's time per step against phase 3's card time of its instance.
BENCH_SPMV_TOL = 0.2


def bench_ext_names(n):
    """orc_tpu's extended bench line names at n^2 cells, in its order,
    where the fused-kernel gate gives a spec with the in-kernel gradient
    (the card)."""
    return [
        f"shift SpMV bandwidth, {n}^2 f32",
        f"flux+momentum+p-corr assembly bandwidth, {n}^2 f32",
        f"FUSED momentum+p-corr assembly bandwidth, {n}^2 f32 (shipped default)",
        f"FUSED assembly bandwidth, CD1+SecondOrder+RhieChow "
        f"(reference-default schemes), {n}^2 f32",
        f"FUSED assembly CD1+SecondOrder+RhieChow, in-kernel-GG traffic "
        f"accounting, {n}^2 f32",
        f"cavity {n}^2 f32 UD BiCGSTAB(50), one chip",
        f"cavity {n}^2 f32 CD1+SecondOrder+RhieChow (reference-default schemes), one chip",
    ]


def phase_cli_bench(dev, kernels, shapes, iters=50, n_ext=1024):
    """23e: the `bench` subcommand (orc_tpu_torch/bench.py) at BENCH_ITERS
    = `iters` with the extended lines at BENCH_EXT_N = `n_ext` (1024,
    phase 3's shapes): the seven lines in orc_tpu's order, finite and
    positive, then the headline; nothing failed on stderr; line 1's time
    per step (its bytes over its GB/s) within BENCH_SPMV_TOL of phase
    3's card time of the same instance, lines 3 and 4's no lower than
    the sum of phase 3's card times of their momentum and p' instances
    (`shapes`: phase_kernels' (C, K) of those instances). Returns {"lines", "line_ms", "phase3_ms", "seconds"}."""
    import contextlib
    import io
    import math
    import os

    from orc_tpu_torch import bench

    env = {"BENCH_ITERS": str(iters), "BENCH_EXTENDED": "1", "BENCH_EXT_N": str(n_ext)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            output, secs = run_cli(["bench", "--device", dev])
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
        log("  bench stderr:\n    " + "\n    ".join(err.getvalue().strip().splitlines()))
    lines = [json.loads(x) for x in output.strip().splitlines()]
    log(f"  bench ({secs:.2f} s):")
    for line in lines:
        log(f"    {json.dumps(line)}")
    if "extended metrics failed" in err.getvalue():
        raise AssertionError("bench: the extended metrics failed")
    names = [line["metric"] for line in lines[:-1]]
    if names != bench_ext_names(n_ext):
        raise AssertionError(f"bench: extended lines {names}")
    if not lines[-1]["metric"].startswith("SIMPLE iters/sec, couette_128x64x1"):
        raise AssertionError(f"bench: the last line is not the headline: {lines[-1]}")
    for line in lines:
        if not (math.isfinite(line["value"]) and line["value"] > 0):
            raise AssertionError(f"bench: {line}")
    by_name = {k.name: k for k in kernels}
    spmv, mom, pc = (by_name[n] for n in ("shift_spmv", "momentum_assembly", "pc_assembly"))
    (C, K), (Cf, Kf) = shapes["spmv"], shapes["fused"]
    nbytes = {1: bench.spmv_bytes(C, K), 3: bench.fused_bytes(Cf, Kf),
              4: bench.fused_rc_bytes(Cf, Kf)}
    line_ms = {i: 1e3 * nbytes[i] / (lines[i - 1]["value"] * 1e9) for i in nbytes}
    ref_ms = {1: spmv.card[BENCH_SPMV_LABEL]}
    for i, (m_label, p_label) in BENCH_PAIRS.items():
        ref_ms[i] = mom.card[m_label] + pc.card[p_label]
    for i in sorted(line_ms):
        log(f"  line {i}: {line_ms[i]:.4f} ms per step; phase 3 "
            f"{'kernel' if i == 1 else 'momentum + p-corr kernels'} {ref_ms[i]:.4f} ms "
            f"(ratio {line_ms[i] / ref_ms[i]:.3f})")
    if abs(line_ms[1] / ref_ms[1] - 1) > BENCH_SPMV_TOL:
        raise AssertionError(
            f"bench line 1: {line_ms[1]:.4f} ms per step, phase 3's card time "
            f"{ref_ms[1]:.4f} ms (tol {BENCH_SPMV_TOL:.0%})"
        )
    for i in BENCH_PAIRS:
        if line_ms[i] < ref_ms[i]:
            raise AssertionError(
                f"bench line {i}: the pair's {line_ms[i]:.4f} ms per step is below "
                f"its two kernels' {ref_ms[i]:.4f} ms"
            )
    return dict(lines=lines, line_ms=line_ms, phase3_ms=ref_ms, seconds=secs)


def phase_cli_card_cpu(dev, examples_dir, n=16, iterations=20):
    """23f: `run --device cuda` against `run --device cpu` on an n^2
    cavity.toml and on the relabelled n^2 TGRID cavity: the checkpoints'
    vel, p and mom_diag within CLI_CARD_CPU_TOL of scale, the histories'
    inner iteration counts equal."""
    text = (examples_dir / "cavity.toml").read_text()
    mesh_path, _ = relabelled_cavity(cli_dir("card-cpu-mesh"), n)
    worst = {}
    for label, kw in (("box", dict(dims=(n, n, 1))), ("relabelled", dict(mesh=mesh_path))):
        ckpts = {}
        for device in (dev, "cpu"):
            out = cli_dir("card-cpu", label, str(device))
            case = out / "case.toml"
            case.write_text(case_copy(text, out, iterations=iterations, data=False, **kw))
            run_cli(["run", case, "--history", out / "history.npz", "--device", device])
            ckpts[str(device)] = out
        a, b = (npz(ckpts[k] / "checkpoint.npz") for k in (str(dev), "cpu"))
        ha, hb = (npz(ckpts[k] / "history.npz") for k in (str(dev), "cpu"))
        gaps = {
            k: float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-300))
            for k in ("vel", "p", "mom_diag")
        }
        same_iters = all(np.array_equal(ha[k], hb[k]) for k in ("mom_iters", "pc_iters"))
        log(f"  {label} {n}^2: card vs CPU error/scale {gaps}; equal inner counts {same_iters}")
        if not (all(g <= CLI_CARD_CPU_TOL for g in gaps.values()) and same_iters):
            raise AssertionError(f"card-cpu {label}: the card's run left the CPU's")
        worst[label] = max(gaps.values())
    return worst


def phase_cli(dev, kernels, twin_ms, bench_shapes, tgrid_n=256, n_1m=1024):
    """23: the CLI on the card (orc_tpu_torch.cli.main in this process):
    (a) the examples, (b) resume, (c) the relabelled TGRID case (256^2:
    at 448^2 its host work alone, the Python parse inside the VTK writer,
    three mesh compiles and the text, takes most of the phase's 90 s),
    (d) cli-1M, (e) bench, (f) the card against the CPU; each sub-phase's
    seconds."""
    import pathlib

    log(f"== phase 23: the CLI on the card (orc_tpu_torch.cli.main), {tgrid_n}^2 relabelled TGRID case")
    examples_dir = pathlib.Path(__file__).resolve().parent / "examples"
    t_start = time.perf_counter()
    secs = {}
    t0 = time.perf_counter()
    runs = phase_cli_examples(dev, kernels, examples_dir)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_cli_resume(dev, runs)
    secs["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tgrid = phase_cli_tgrid(dev, kernels, examples_dir, tgrid_n)
    secs["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one_m = phase_cli_1m(dev, kernels, examples_dir, twin_ms, n_1m)
    secs["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bench = phase_cli_bench(dev, kernels, bench_shapes)
    secs["e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_cpu = phase_cli_card_cpu(dev, examples_dir)
    secs["f"] = time.perf_counter() - t0
    total = time.perf_counter() - t_start
    log(f"  phase 23 {total:.1f} s (budget 90 s): "
        + ", ".join(f"23{k} {v:.1f} s" for k, v in secs.items()))
    return dict(
        seconds=total, sub_seconds=secs, examples={k: v[2] for k, v in runs.items()},
        tgrid=tgrid, cli_1m=one_m, bench=bench, card_cpu=card_cpu,
    )


#: Sharded runs on the card against the single-device run on the card
#: (they differ by the order of the reductions only) and against the same
#: sharded run on the CPU (equal inner iteration counts).
SHARDED_SINGLE_TOL = 1e-8
SHARDED_CARD_CPU_TOL = 1e-9


def _sharded_cases():
    """Phase 24a's runs: (label, partitions, run(device, devices or None)
    -> (FlowState, stacked StepMetrics)[, the assembly kernels the sharded
    run on the card must launch and how many times]); devices None runs
    one device. The three-slab runs' windows (86 cells of the 16^2
    cavity) start and end inside rows."""
    from orc_tpu_torch.models.cavity import (
        cavity_case,
        default_settings,
        flagship_settings,
    )
    from orc_tpu_torch.parallel.sharded import (
        solve_steady_sharded,
        solve_transient_sharded,
    )
    from orc_tpu_torch.solver.simple import solve_steady, stack_history
    from orc_tpu_torch.solver.transient import solve_transient
    from orc_tpu_torch.solver.turbulence import (
        solve_steady_turbulent,
        solve_steady_turbulent_sharded,
    )

    def steady(build, settings, iterations=6, method="auto"):
        def run(d, devices):
            mesh, table = build(d)
            kw = dict(iterations=iterations, reporting_interval=iterations, verbose=False)
            if devices is None:
                state, hist = solve_steady(mesh, table, settings, 1.0, 0.01, **kw)
            else:
                state, hist = solve_steady_sharded(
                    mesh, table, settings, 1.0, 0.01, partition_method=method,
                    devices=devices, **kw,
                )
            return state, stack_history(hist)
        return run

    def transient(d, devices):
        mesh, table = cavity_case(n=16, device=d)
        kw = dict(dt=0.05, n_steps=3, inner_iterations=4, verbose=False)
        if devices is None:
            return solve_transient(mesh, table, default_settings(), 1.0, 0.01, **kw)
        return solve_transient_sharded(
            mesh, table, default_settings(), 1.0, 0.01, devices=devices, **kw
        )

    def rans(d, devices):
        mesh, table = rans_channel(d, 16, 12, torch.float64)
        kw = dict(iterations=2, reporting_interval=2, verbose=False, **CHANNEL_TURB)
        if devices is None:
            flow, _, hist = solve_steady_turbulent(mesh, table, rans_settings(), 1.0, 1e-5, **kw)
        else:
            flow, _, hist = solve_steady_turbulent_sharded(
                mesh, table, rans_settings(), 1.0, 1e-5, devices=devices, **kw
            )
        return flow, stack_history(hist)

    def cavity(d):
        return cavity_case(n=16, device=d)

    def permuted(d):
        mesh, table, _ = permuted_cavity(16, torch.float64, d)
        return mesh, table

    mg = default_settings().replace(matrix_solver=mg_settings())
    return (
        ("parity slab", 2, steady(cavity, default_settings())),
        ("parity slab, ragged windows", 3, steady(cavity, default_settings()),
         dict(momentum=18, pc=18)),
        ("SIMPLE_FC slab, ragged windows", 3, steady(cavity, flagship_settings()),
         dict(fc_momentum=18, fc_pc=18)),
        ("reference-default slab", 4, steady(cavity, ref_default_settings())),
        ("parity rcb (face-major)", 4, steady(cavity, default_settings(), method="rcb")),
        ("SIMPLE_FC slab", 4, steady(cavity, flagship_settings())),
        ("transient slab", 2, transient),
        ("GMG slab", 4, steady(cavity, mg)),
        ("AMG rcb, permuted", 4, steady(permuted, mg)),
        ("RANS channel 16x12 slab", 4, rans),
    )


def phase_sharded_small(dev, cases=None):
    """24a: the sharded solvers on small f64 cases, 2, 3 and 4 partitions
    on the one card (`devices=[card] * P`): each within SHARDED_SINGLE_TOL of
    the single-device run on the card and within SHARDED_CARD_CPU_TOL of
    the same sharded run on the CPU, with equal inner iteration counts;
    then `run --devices 2` through the CLI, cut to the one visible card
    as orc_tpu's jax.devices()[:n] cuts it."""
    log("== phase 24a: sharded slices, 2, 3 and 4 partitions on the one card, against one device and the CPU")
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    for label, parts, run, *want in cases or _sharded_cases():
        single = run(dev, None)
        before = _assembly_launches()
        card = run(dev, [dev] * parts)
        if want:
            after = _assembly_launches()
            got = {k: after[k] - before[k] for k in want[0]}
            log(f"  {label}: assembly kernel launches {got}")
            if got != want[0]:
                raise AssertionError(f"{label}: launches {got}, expected {want[0]}")
        host = run(cpu, [cpu] * parts)
        gaps = {
            n: max_err(getattr(card[0], n).cpu(), getattr(single[0], n).cpu())[1][0]
            for n in ("vel", "p")
        }
        log(
            f"  {label}, {parts} partitions: sharded vs one device on the card, error / "
            f"scale " + " ".join(f"{n} {e:.3e}" for n, e in gaps.items())
            + f" (tol {SHARDED_SINGLE_TOL:.0e})"
        )
        if not all(e <= SHARDED_SINGLE_TOL for e in gaps.values()):
            raise AssertionError(f"{label}: the sharded run left the single-device one")
        _card_cpu_gap(f"{label} sharded", (card, host), SHARDED_CARD_CPU_TOL)
    text = (pathlib_repo() / "examples" / "cavity.toml").read_text()
    out = cli_dir("sharded")
    case = out / "case.toml"
    case.write_text(case_copy(text, out, iterations=4, dims=(16, 16, 1), reporting=2))
    output, secs = run_cli(["run", case, "--devices", "2"])
    cut = "[1 devices] Iteration" in output
    log(f"  cli run --devices 2: {secs:.1f} s, cut to the one visible card: {cut}")
    if not cut:
        raise AssertionError("run --devices 2 did not run sharded over the one visible card")
    return dict(seconds=time.perf_counter() - t0)


def pathlib_repo():
    import pathlib

    return pathlib.Path(__file__).resolve().parent


def _sharded_run(mesh, table, settings, rho, mu, warm, timed, parts, dev):
    """solve_steady_sharded over `parts` partitions on the card from rest,
    warm + timed iterations in chunks of `warm`: (state, the timed
    chunks' histories, ms/iter of the timed chunks by the solver's own
    clock, which leaves the partitioning out)."""
    import contextlib
    import io

    from orc_tpu_torch.parallel.sharded import solve_steady_sharded

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state, hist = solve_steady_sharded(
            mesh, table, settings, rho, mu, iterations=warm + timed,
            reporting_interval=warm, devices=[dev] * parts,
        )
    torch.cuda.synchronize()
    return state, hist[1:], float(np.mean(chunk_ms(buf.getvalue())[1:]))


def _sharded_window(mesh, table, settings, rho, mu, state, parts, dev, iterations=3):
    """profile_window over `iterations` sharded iterations alone: the
    partitions, their state and their steps are built first, with the
    solver's own set-up, and `iterations` run once outside the window
    (the first V-cycle builds each partition's coarse tables)."""
    from orc_tpu_torch.parallel import sharded

    s = sharded._setup(
        mesh, table, settings, mu, None, [dev] * parts, "auto", "auto", state
    )
    run = sharded.make_sharded_step(
        s["partition"], settings, n_steps=iterations, use_ck=s["use_ck"],
        n_zones=len(table.zone_ids), mg_hierarchy=s["mg"],
        maybe_singular=s["maybe_singular"], use_fc=s["use_fc"],
        kernel_asm=s["kernel_asm"],
    )
    local, _ = run(s["local"], *s["zones"], rho, mu)
    return profile_window(
        lambda: _timed_run(lambda: run(local, *s["zones"], rho, mu)), iterations
    )


def _assembly_launches():
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.ops.fused_smooth import fused_jacobi_sweeps
    from orc_tpu_torch.ops.shift_spmv import shift_spmv

    return dict(
        momentum=asm.momentum_assembly.launches, pc=asm.pc_assembly.launches,
        fc_momentum=asm.fc_momentum_assembly.launches, fc_pc=asm.fc_pc_assembly.launches,
        shift_spmv=shift_spmv.launches, sweeps=fused_jacobi_sweeps.launches,
    )


def phase_sharded_full(dev, label, twin, build, settings, mu, warm, timed, parts=4,
                       kernels=("momentum", "pc")):
    """24b-d: one full-width cell over `parts` slab partitions of the one
    card, `warm` + `timed` iterations from rest, then 3 + a profile
    window of 3 from that state:
    the assembly `kernels` launched once per partition per iteration (no
    plain assembly, no fused sweep: the momentum smoother refreshes its
    halo every sweep), finite |u| < 2, the median pressure residual of
    the timed iterations within twice the single-device twin's over the
    same iterations (`twin`: that phase's result), ms/iter and the busy
    share beside the twin's."""
    from orc_tpu_torch.solver import simple

    mesh, table = build(dev)
    passes = []
    real = simple.ck_pressure_gradient

    def counted(*args, **kw):
        passes.append(1)
        return real(*args, **kw)

    before = _assembly_launches()
    simple.ck_pressure_gradient = counted
    try:
        t0 = time.perf_counter()
        state, hist, ms = _sharded_run(mesh, table, settings, 1.0, mu, warm, timed, parts, dev)
        window = _sharded_window(mesh, table, settings, 1.0, mu, state, parts, dev)
        wall = time.perf_counter() - t0
    finally:
        simple.ck_pressure_gradient = real
    after = _assembly_launches()
    n_it = warm + timed + 6
    per_it = {k: (after[k] - before[k]) / n_it for k in after}
    u = state.vel.cpu().numpy()
    pc_res = float(np.median(np.concatenate([h.pc_residual.cpu().numpy() for h in hist])))
    tw = np.asarray(twin["pc_residual"])[warm - twin["warm"]:][:timed]
    twin_res = float(np.median(tw))
    log(
        f"  {parts} slabs: {warm} + {timed} iterations, then 3 + a window of 3 ({wall:.1f} s with "
        f"two partitionings): {ms:.2f} ms/iter by the solver's clock, {window['window_ms_per_iter']:.2f} "
        f"in the window (one device {twin['ms_per_iter']:.2f}), device busy "
        f"{100 * window['busy']:.1f}% (one device {100 * twin['busy']:.1f}%), "
        f"{window['launches_per_iter']:.0f} launches per iteration (one device "
        f"{twin['launches_per_iter']:.0f}); |u| max {np.abs(u).max():.3f}"
    )
    log(
        f"  launches per iteration: {per_it}; streamed grad-p passes per iteration "
        f"{len(passes) / n_it:.2f}; median pressure residual {pc_res:.3e} (one device "
        f"{twin_res:.3e} over the same iterations, limit twice that)"
    )
    if not (np.isfinite(u).all() and np.abs(u).max() < 2.0):
        raise AssertionError(f"{label}: fields not finite or |u| >= 2")
    for k in kernels:
        if after[k] - before[k] != parts * n_it:
            raise AssertionError(f"{label}: {k} launched other than once per partition per iteration")
    if after["sweeps"] != before["sweeps"]:
        raise AssertionError(f"{label}: a fused sweep ran under a halo refresh")
    if "momentum" in kernels and settings.velocity_interpolation.name == "RHIE_CHOW" \
            and len(passes) != parts * n_it:
        raise AssertionError(f"{label}: the kernels did not take the streamed gradient")
    if not pc_res <= 2.0 * twin_res:
        raise AssertionError(f"{label}: the sharded pressure solves left more residual than one device's")
    return dict(
        iterations=parts * n_it, ms_per_iter=ms, window_ms_per_iter=window["window_ms_per_iter"],
        busy=window["busy"], launches_per_iter=window["launches_per_iter"], per_it=per_it,
        pc_residual=pc_res, twin_pc_residual=twin_res, seconds=wall,
    )


def _timed_run(run):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_sharded_refdef(dev, twin, n=1024):
    """24b: refdef-1M's numerics (phase 11) over 4 slabs of the one card."""
    log("== phase 24b: refdef-1M 1024^2 f32 (CD1 + SO + RC, forced SIMPLE), 4 slabs on the one card")
    from orc_tpu_torch.models.cavity import cavity_case

    def build(d):
        return cavity_case(n=n, dtype=torch.float32, device=d)

    return phase_sharded_full(dev, "refdef-1M x4", twin, build, ref_default_settings(), 1e-3, 10, 30)


def phase_sharded_fc(dev, twin, n=1024):
    """24c: fc-cavity-1M's numerics (phase 7) over 4 slabs of the one card."""
    log("== phase 24c: fc-cavity-1M 1024^2 f32 (SIMPLE_FC, Ghia flagship numerics), 4 slabs on the one card")
    from orc_tpu_torch.models.cavity import cavity_case, flagship_settings

    def build(d):
        return cavity_case(n=n, dtype=torch.float32, device=d)

    return phase_sharded_full(
        dev, "fc-cavity-1M x4", twin, build, flagship_settings(), 1e-3, 10, 30,
        kernels=("fc_momentum", "fc_pc"),
    )


def phase_sharded_3d(dev, twin, n=128):
    """24d: cavity3d-128 under MULTIGRID (phase 15) over 4 slabs of the
    one card: the geometric V-cycle's fine level distributed, its coarse
    correction replicated on every partition."""
    log("== phase 24d: cavity3d-128 f32 MULTIGRID (5 levels), 4 slabs on the one card")
    from orc_tpu_torch.models.cavity import cavity_case

    def build(d):
        return cavity_case(n=n, nz=n, dtype=torch.float32, device=d)

    settings = bench_irregular_settings().replace(
        pressure_relaxation=CAVITY_3D_PRESSURE_RELAXATION,
        matrix_solver=mg_settings(levels=5, smoother=4),
    )
    return phase_sharded_full(dev, "cavity3d-128 x4", twin, build, settings, 1e-2, 5, 10)


class PlainOnCard:
    """Counts calls of the plain versions of rows 1 and 2 with a CUDA
    tensor, and of row 13's (`fm_momentum_plain`) with a CUDA tensor
    under a configuration the kernel takes (`fm_assembly.takes`), while
    installed. None may happen on a main path: there a CUDA tensor
    launches the kernel or raises."""

    def __init__(self):
        from orc_tpu_torch.ops import fm_assembly, fused_smooth, shift_spmv

        def cuda(a, k):
            return any(isinstance(t, torch.Tensor) and t.is_cuda for t in a)

        def fm_taken(a, k):  # (mesh, fbc, settings, rho, vel, ...)
            return a[4].is_cuda and fm_assembly.takes(a[2], a[4].dtype)

        self.mods = (
            (shift_spmv, "shift_spmv_plain", cuda),
            (fused_smooth, "sweeps_plain", cuda),
            (fm_assembly, "fm_momentum_plain", fm_taken),
        )
        self.real = [getattr(m, n) for m, n, _ in self.mods]
        self.calls = {n: 0 for _, n, _ in self.mods}

    def __enter__(self):
        for (mod, name, on_card), fn in zip(self.mods, self.real):
            def counted(*a, _fn=fn, _name=name, _on_card=on_card, **k):
                if _on_card(a, k):
                    self.calls[_name] += 1
                return _fn(*a, **k)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.mods, self.real):
            setattr(mod, name, fn)


def profile(mesh, table, settings, rho, mu, state, iterations, use_ck="auto"):
    """torch.profiler over a few steady iterations (profile_window)."""
    return profile_window(
        lambda: _timed_solve(
            mesh, table, settings, rho, mu, state, iterations, iterations, use_ck
        )[2],
        iterations,
    )


def profile_window(run, iterations):
    """torch.profiler around `run` (which synchronizes and returns its
    wall seconds) over `iterations` outer or inner iterations: device
    time by kernel, the device's busy share of the window and the
    launches per iteration, which it returns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dt = run()
    rows = [  # device-side kernel events only (op rows would double-count)
        (ev.self_device_time_total, ev.key, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    busy_us = sum(t for t, _, _ in rows)
    n_launch = sum(c for _, _, c in rows)
    log(
        f"  profile, {iterations} iterations: wall {1e3 * dt:.1f} ms, kernel "
        f"time {busy_us / 1e3:.1f} ms (device busy {100 * busy_us / 1e6 / dt:.1f}%), "
        f"{n_launch} kernel launches ({n_launch / iterations:.0f} per iteration)"
    )
    for t, key, count in sorted(rows, reverse=True)[:12]:
        log(f"    {t / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
    return dict(
        busy=busy_us / 1e6 / dt, launches_per_iter=n_launch / iterations,
        window_ms_per_iter=1e3 * dt / iterations,
    )


def all_kernels():
    """A Kernel per kernel (and per instance counted apart), in the order
    of the summary line."""
    from orc_tpu_torch.ops import fused_assembly as asm
    from orc_tpu_torch.ops.fm_assembly import fm_momentum_assembly
    from orc_tpu_torch.ops.fused_smooth import fused_jacobi_sweeps
    from orc_tpu_torch.ops.shift_spmv import shift_spmv
    from orc_tpu_torch.ops.slice_spmv import (
        slice_nbr_values,
        slice_spmv,
        slice_spmv_exact,
    )

    parity_src = "orc_tpu_torch/csrc/parity_assembly.cuh"
    asm_src = "orc_tpu_torch/csrc/assembly.cu"
    slice_src = "orc_tpu_torch/csrc/slice_spmv.cu"
    return (
        Kernel("shift_spmv", shift_spmv, "orc_tpu_torch/csrc/shift_spmv.cu",
               "orc_tpu/ops/pallas_spmv.py:39"),
        Kernel("fused_jacobi_sweeps", fused_jacobi_sweeps,
               "orc_tpu_torch/csrc/jacobi_sweeps.cu",
               "orc_tpu/ops/pallas_smooth.py:98"),
        Kernel("momentum_assembly", asm.momentum_assembly, parity_src,
               "orc_tpu/ops/pallas_assembly.py:189"),
        Kernel("pc_assembly", asm.pc_assembly, parity_src,
               "orc_tpu/ops/pallas_assembly.py:632"),
        Kernel("fc_momentum_assembly", asm.fc_momentum_assembly, asm_src,
               "orc_tpu/ops/pallas_assembly.py:189"),
        Kernel("fc_pc_assembly", asm.fc_pc_assembly, asm_src,
               "orc_tpu/ops/pallas_assembly.py:856"),
        Kernel("momentum_assembly[transient]", asm.momentum_assembly, parity_src,
               "orc_tpu/ops/pallas_assembly.py:410", counter="transient_launches"),
        Kernel("fc_momentum_assembly[transient]", asm.fc_momentum_assembly, asm_src,
               "orc_tpu/ops/pallas_assembly.py:410", counter="transient_launches"),
        Kernel("slice_spmv", slice_spmv, slice_src,
               "orc_tpu/ops/pallas_slice.py:47"),
        Kernel("slice_nbr_values", slice_nbr_values, slice_src,
               "orc_tpu/ops/pallas_slice.py:574"),
        Kernel("slice_spmv_exact", slice_spmv_exact, slice_src,
               "orc_tpu/ops/pallas_slice.py:798"),
        Kernel("shift_spmv[per-row]", shift_spmv, "orc_tpu_torch/csrc/shift_spmv.cu",
               "orc_tpu/ops/pallas_spmv.py:39", counter="per_row_launches"),
        Kernel("fused_jacobi_sweeps[per-row]", fused_jacobi_sweeps,
               "orc_tpu_torch/csrc/jacobi_sweeps.cu", "orc_tpu/ops/pallas_smooth.py:98",
               counter="per_row_launches"),
        Kernel("fused_jacobi_sweeps[march]", fused_jacobi_sweeps,
               "orc_tpu_torch/csrc/jacobi_sweeps.cu", "orc_tpu/ops/pallas_smooth.py:98",
               counter="march_launches"),
        Kernel("slice_spmv[amg coarse]", slice_spmv, slice_src,
               "orc_tpu/ops/pallas_slice.py:47", counter="spmv_only_launches"),
        Kernel("fm_momentum_assembly", fm_momentum_assembly,
               "orc_tpu_torch/csrc/fm_assembly.cu",
               "orc_tpu/ops/assembly.py:74 (plain jnp, no kernel)"),
    )


def main():
    from orc_tpu_torch.ops.fused_smooth import fused_jacobi_sweeps

    dev = phase_device()
    phase_build()
    kernels = all_kernels()
    (spmv, sweeps, mom, pc, fc_mom, fc_pc, mom_t, fc_mom_t, sspmv, snbr, sexact,
     spmv_pr, sweeps_pr, march, amg_coarse, fm) = kernels
    bench_shapes = phase_kernels(dev, (spmv, sweeps, mom, pc), mom_t, march)
    phase_per_row_kernels(dev, spmv_pr, sweeps_pr)
    phase_parity_branches(dev, mom, pc, mom_t)
    phase_fc_kernels(dev, fc_mom, fc_pc, fc_mom_t)
    phase_fm_kernels(dev, fm)
    phase_slice_kernels(dev, sspmv, snbr)
    phase_amg_coarse_kernels(dev, amg_coarse)
    exact = phase_exact_kernel(dev, sexact, sspmv)
    phase_small_reference(dev)
    phase_small_reference_irregular(dev)
    phase_small_reference_transient(dev)
    phase_small_reference_schemes(dev)
    phase_small_reference_face_major(dev)
    phase_small_reference_solvers(dev)
    sharded_small = phase_sharded_small(dev)

    # The main paths, each driven with the launch counts set to 0 just
    # before it and read just after it.
    parity, fc = (spmv, sweeps, mom, pc), (spmv, sweeps, fc_mom, fc_pc)
    per_row = (spmv_pr, sweeps_pr)
    # Instances only some paths launch: the transient ones, the per-row
    # branches, the 3-D march and kernel 7 on multigrid coarse plans.
    extra = (mom_t, fc_mom_t) + per_row + (march, amg_coarse)
    assembly = (mom, pc, fc_mom, fc_pc, mom_t, fc_mom_t)
    structured = (spmv, sweeps, mom, pc, fc_mom, fc_pc) + extra
    irregular = (sspmv, snbr, sexact)
    # Row 13 runs only where the face-major step meets settings it takes;
    # the (c,k) paths launch none of it (the CLI's mix is not checked).
    no_fm = (fm,)
    results = {}
    paths = (  # label, run, kernels it must launch, kernels it must not,
        # kernels it must launch exactly once per (inner) iteration
        ("parity couette", lambda: phase_couette(dev), (spmv,), irregular + extra + no_fm, ()),
        ("parity cavity", lambda: phase_cavity(dev), parity,
         (fc_mom, fc_pc) + extra + irregular + no_fm, ()),
        ("fc couette", lambda: phase_couette(dev, fc=True), fc,
         (mom, pc) + extra + irregular + no_fm, ()),
        ("fc cavity", lambda: phase_cavity(dev, fc=True), fc,
         (mom, pc) + extra + irregular + no_fm, ()),
        ("fc sequenced", lambda: phase_sequenced(dev), fc,
         (mom, pc) + extra + irregular + no_fm, ()),
        ("irregular cavity", lambda: phase_irregular_cavity(dev), (sspmv, snbr),
         structured + (sexact,) + no_fm, ()),
        ("structured twin", lambda: phase_irregular_twin(dev, results["irregular cavity"]),
         parity, extra + irregular + no_fm, ()),
        ("irregular couette",
         lambda: phase_irregular_couette(dev, results["parity couette"]["u_mean"]),
         (sspmv, snbr), structured + (sexact,) + no_fm, ()),
        ("reference-default cavity", lambda: phase_ref_default_cavity(dev), parity,
         (fc_mom, fc_pc) + extra + irregular + no_fm, (mom, pc)),
        ("df32_ir", lambda: phase_df32(dev), irregular, structured + no_fm, ()),
        ("transient cavity", lambda: phase_transient_cavity(dev), parity + (mom_t,),
         (fc_mom, fc_pc, fc_mom_t) + irregular + no_fm, (mom, pc, mom_t)),
        ("transient fc cavity", lambda: phase_transient_cavity(dev, fc=True),
         fc + (fc_mom_t,), (mom, pc, mom_t) + irregular + no_fm,
         (fc_mom, fc_pc, fc_mom_t)),
        ("3-D cavity multigrid", lambda: phase_cavity_3d(dev), parity + (march,),
         (fc_mom, fc_pc, mom_t, fc_mom_t) + per_row + irregular + no_fm, ()),
        ("taylor-green", lambda: phase_taylor_green(dev), (spmv, sweeps),
         (mom, pc, fc_mom, fc_pc) + extra + irregular + no_fm, ()),
        ("rans channel", lambda: phase_rans_channel(dev), (spmv, sweeps),
         assembly + per_row + irregular + no_fm, ()),
        ("re_tau parity", lambda: phase_re_tau(dev), (spmv,),
         assembly + per_row + irregular + (sweeps,) + no_fm, ()),
        ("re_tau fc", lambda: phase_re_tau(dev, fc=True), (spmv, sweeps),
         assembly + per_row + irregular + no_fm, ()),
        ("lsq cavity", lambda: phase_lsq(dev), parity,
         (fc_mom, fc_pc) + extra + irregular + no_fm, (mom, pc)),
        ("lsq fc cavity", lambda: phase_lsq(dev, fc=True), fc,
         (mom, pc) + extra + irregular + no_fm, (fc_mom, fc_pc)),
        ("tvd cavity", lambda: phase_tvd_cavity(dev), (spmv, sweeps) + per_row,
         assembly + irregular + no_fm, ()),
        ("cd2 couette", lambda: phase_cd2_couette(dev), (spmv, spmv_pr),
         assembly + irregular + (sweeps, sweeps_pr) + no_fm, ()),
        # Phase 21: the face-major step assembles its momentum systems in
        # row 13, once an iteration, where it takes the settings (UD, CD1,
        # TVD_DC under linear face pressures), in plain ops as in orc_tpu
        # otherwise (fm-couette: CD1 under SECOND_ORDER face pressures),
        # the rest in plain ops, and solves through rows 1, 2 and 7.
        ("fm-couette", lambda: phase_fm_couette(dev, results["parity couette"]["u_mean"]),
         (spmv,), assembly + extra + irregular + no_fm, ()),
        ("fm-cavity-1M", lambda: phase_fm_cavity(dev, results["parity cavity"]),
         (spmv, sweeps, fm), assembly + extra + irregular, (fm,)),
        ("fm-fc-cavity-1M", lambda: phase_fm_fc_cavity(dev, results["fc cavity"]),
         (spmv, sweeps, fm),
         assembly + extra + irregular, (fm,)),
        ("ggnode-448", lambda: phase_ggnode(dev), (sspmv, fm),
         structured + (snbr, sexact), (fm,)),
        ("fm-auto-216", lambda: phase_fm_auto_216(dev), (spmv, sweeps, march, fm),
         assembly + (mom_t, fc_mom_t) + per_row + irregular + (amg_coarse,), (fm,)),
        # Phase 22: the algebraic multigrid (kernel 7 on its coarse plans),
        # Gauss-Seidel, initialize_flow and solve_channel_flow.
        ("amg-448", lambda: phase_amg_448(dev), (sspmv, snbr, amg_coarse),
         tuple(k for k in structured if k is not amg_coarse) + (sexact,) + no_fm, ()),
        ("gs-cavity-1M", lambda: phase_gs_cavity(dev, results["parity cavity"]), parity,
         (fc_mom, fc_pc) + extra + irregular + no_fm, ()),
        ("init-channel", lambda: phase_init_channel(dev), (spmv,),
         assembly + extra + irregular + (sweeps,) + no_fm, ()),
        ("channel-128x64", lambda: phase_channel_128(dev), (spmv,),
         extra + irregular + no_fm, ()),
        # Phase 23: the CLI, in this process: the examples, resume, the
        # relabelled TGRID case, cli-1M, bench and the card against the CPU.
        ("cli", lambda: phase_cli(
            dev, kernels, results["parity cavity"]["ms_per_iter"], bench_shapes),
         parity + (sspmv, snbr), (sexact,), ()),
        # Phase 24: the sharded runtime, 4 slab partitions on the one card;
        # "once per iteration" reads once per partition per iteration (the
        # phases return partitions x iterations), and no fused sweep may
        # run: the momentum smoother refreshes its halo every sweep.
        ("refdef-1M x4",
         lambda: phase_sharded_refdef(dev, results["reference-default cavity"]),
         (spmv, mom, pc), (fc_mom, fc_pc, sweeps) + extra + irregular + no_fm,
         (mom, pc)),
        ("fc-cavity-1M x4", lambda: phase_sharded_fc(dev, results["fc cavity"]),
         (spmv, fc_mom, fc_pc), (mom, pc, sweeps) + extra + irregular + no_fm,
         (fc_mom, fc_pc)),
        ("cavity3d-128 x4",
         lambda: phase_sharded_3d(dev, {
             **results["3-D cavity multigrid"]["MULTIGRID"],
             **results["3-D cavity multigrid"]["profile"],
         }),
         (spmv, mom, pc), (fc_mom, fc_pc, sweeps) + extra + irregular + no_fm,
         (mom, pc)),
    )
    launches = {k.name: 0 for k in kernels}
    for label, run, must, must_not, per_iteration in paths:
        for k in kernels:
            setattr(k.fn, k.counter, 0)
        fused_jacobi_sweeps.instances = {}
        with PlainOnCard() as plain:
            results[label] = run()
        if any(plain.calls.values()):
            raise AssertionError(f"the {label} run ran plain versions on the card: {plain.calls}")
        counts = {k.name: getattr(k.fn, k.counter) for k in kernels}
        log(f"launches, {label}: {counts}")
        if fused_jacobi_sweeps.instances:
            log(f"  fused_jacobi_sweeps instances (calls), {label}: "
                f"{fused_jacobi_sweeps.instances}")
        for k in must:
            if counts[k.name] <= 0:
                raise AssertionError(f"the {label} run launched no {k.name} kernel")
        for k in must_not:
            if counts[k.name] != 0:
                raise AssertionError(f"the {label} run launched {k.name}")
        n_it = (results[label] or {}).get("iterations")
        if per_iteration and not all(counts[k.name] == n_it for k in per_iteration):
            raise AssertionError(
                f"the {label} run launched its assembly kernels other than once "
                f"per iteration ({n_it} iterations)"
            )
        for name, n in counts.items():
            launches[name] += n
    df = results["df32_ir"]
    log(
        f"summary: couette f64 {results['parity couette']['iters_per_s']:.1f} "
        f"iters/s; cavity 1024^2 f32 {results['parity cavity']['ms_per_iter']:.2f} "
        f"ms/iter; reference-default cavity 1024^2 f32 "
        f"{results['reference-default cavity']['ms_per_iter']:.2f} ms/iter; "
        f"SIMPLE_FC couette f64 {results['fc couette']['iters_per_s']:.1f} "
        f"iters/s; SIMPLE_FC cavity 1024^2 f32 "
        f"{results['fc cavity']['ms_per_iter']:.2f} ms/iter; irregular cavity "
        f"448^2 f32 {results['irregular cavity']['ms_per_iter']:.2f} ms/iter "
        f"({results['structured twin']['ratio']:.2f}x its structured twin); "
        f"irregular couette f64 {results['irregular couette']['iters_per_s']:.1f} "
        f"iters/s; DF32_IR solve {df['DF32_IR']['ms']:.2f} ms (f32 "
        f"{df['f32 slice']['ms']:.2f}, native f64 {df['native f64']['ms']:.2f}); "
        f"permuted cavity 448^2 f64 DF32_IR {df['cavity DF32_IR']:.2f} ms/iter "
        f"(native {df['cavity native']:.2f}, native at DF32_IR's depth "
        f"{df["cavity native, DF32_IR's depth"]:.2f}); exact residual product card "
        f"{sexact.ms:.4f} ms vs f64 slice SpMV {exact['f64_spmv_ms']:.4f} ms; "
        f"transient cavity 1024^2 f32 {results['transient cavity']['ms_per_iter']:.2f} "
        f"ms per inner iteration (SIMPLE_FC flagship "
        f"{results['transient fc cavity']['ms_per_iter']:.2f}); 3-D cavity 128^3 f32 "
        f"MULTIGRID {results['3-D cavity multigrid']['MULTIGRID']['ms_per_iter']:.2f} "
        f"ms/iter, BiCGSTAB(50) "
        f"{results['3-D cavity multigrid']['BiCGSTAB(50)']['ms_per_iter']:.2f}; "
        f"Taylor-Green 256^2 f64 {results['taylor-green']['ms_per_iter']:.2f} ms per "
        f"inner iteration; RANS channel 1024x512 f32 "
        f"{results['rans channel']['ms_per_iter']:.2f} ms/iter (turbulence_step "
        f"{100 * results['rans channel']['turb_share']:.1f}%); Re_tau 590 4x16 f64 "
        f"{results['re_tau parity']['ms_per_iter']:.2f} ms/iter (SIMPLE_FC "
        f"{results['re_tau fc']['ms_per_iter']:.2f}); least-squares cavity 1024^2 f32 "
        f"{results['lsq cavity']['ms_per_iter']:.2f} ms/iter (SIMPLE_FC "
        f"{results['lsq fc cavity']['ms_per_iter']:.2f}); TVD cavity 1024^2 f32 "
        f"{results['tvd cavity']['ms_per_iter']:.2f} ms/iter; CD2 couette f64 "
        f"{results['cd2 couette']['ms_per_iter']:.3f} ms/iter; face-major: couette "
        f"f64 {results['fm-couette']['ms_per_iter']:.3f} ms/iter, cavity 1024^2 f32 "
        f"{results['fm-cavity-1M']['ms_per_iter']:.2f} (SIMPLE_FC "
        f"{results['fm-fc-cavity-1M']['ms_per_iter']:.2f}), GG node 448^2 f32 "
        f"{results['ggnode-448']['ms_per_iter']:.2f}, 216^3 f32 "
        f"{results['fm-auto-216']['ms_per_iter']:.1f} ms/iter "
        f"({results['fm-auto-216']['peak_gib']:.2f} GiB peak); "
        f"AMG permuted cavity 448^2 f32 {results['amg-448']['MULTIGRID']['ms_per_iter']:.2f} "
        f"ms/iter (BiCGSTAB(50) twin {results['amg-448']['BiCGSTAB(50)']['ms_per_iter']:.2f}), "
        f"Gauss-Seidel cavity 1024^2 f32 {results['gs-cavity-1M']['ms_per_iter']:.2f} ms/iter, "
        f"initialize_flow 1024x512 f32 {results['init-channel']['ms']:.2f} ms, "
        f"solve_channel_flow 128x64 f64 {results['channel-128x64']['ms_per_iter']:.2f} ms/iter; "
        f"phase 22 {sum(results[k]['seconds'] for k in ('amg-448', 'gs-cavity-1M', 'init-channel', 'channel-128x64')):.1f} s; "
        f"CLI: cli-1M {results['cli']['cli_1m']['ms_per_iter']:.2f} ms/iter (in-process "
        f"{results['cli']['cli_1m']['inproc_ms_per_iter']:.2f}), bench "
        f"{results['cli']['bench']['lines'][-1]['value']:.2f} iters/s (23e "
        f"{results['cli']['sub_seconds']['e']:.1f} s with the extended lines), phase 23 "
        f"{results['cli']['seconds']:.1f} s; "
        f"sharded, 4 slabs on the one card: refdef-1M "
        f"{results['refdef-1M x4']['ms_per_iter']:.2f} ms/iter, fc-cavity-1M "
        f"{results['fc-cavity-1M x4']['ms_per_iter']:.2f}, cavity3d-128 MULTIGRID "
        f"{results['cavity3d-128 x4']['ms_per_iter']:.2f}; phase 24 "
        f"{sharded_small['seconds'] + sum(results[k]['seconds'] for k in ('refdef-1M x4', 'fc-cavity-1M x4', 'cavity3d-128 x4')):.1f} s "
        f"(24a {sharded_small['seconds']:.1f}); "
        f"{time.perf_counter() - _T0:.1f} s since the start"
    )
    log(json.dumps({"kernels": [k.summary(launches[k.name]) for k in kernels]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
