"""Multi-partition SIMPLE: one controller, one worker thread per
partition (port of orc_tpu/parallel/sharded.py).

Cells are partitioned (parallel/partition.py); every [C]-indexed field
becomes one local [L] tensor per partition, on that partition's device.
The solvers run each partition's *identical* single-device step
(solver/simple.py, solver/fc.py, solver/turbulence.py) in a worker
thread of its own, with a `ShardedComm` that

- refreshes halo slots by exchanging each ring offset's send rows
  between the partitions' threads (orc_tpu's `ppermute` ring),
- completes reductions over the partitions (`axis_sum`, `axis_min`,
  `axis_max`: orc_tpu's `psum` / `pmin` / `pmax`): each is computed once,
  over the partials in partition order, and every partition receives the
  same bits, so every thread takes the same exits and reaches the same
  collectives.

The threads meet at a `ShardGroup` rendezvous. Several partitions may
share one device (`devices=`: a list of torch devices, repeats allowed),
which is how one card checks the exchange, as orc_tpu's tests run on a
virtual 8-device CPU mesh. An exception in any thread, SolverDivergedError
included, aborts the rendezvous; `run_partitions` re-raises it and no
thread waits on. On a CUDA device the threads launch on its current stream;
partitions on one device share its default stream, and a copy between
devices is ordered after the producer's work by PyTorch's cross-device
copy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from orc_tpu_torch.mesh.zones import BoundaryTable
from orc_tpu_torch.parallel.partition import Partition, partition_mesh
from orc_tpu_torch.solver.simple import (
    FlowState,
    SolverDivergedError,
    StepMetrics,
    _metric_names,
    _refresh_rows,
)
from orc_tpu_torch.utils.settings import (
    GradientReconstruction,
    NumericalSettings,
    PressureVelocityCoupling,
    SolutionMethod,
)


class ShardAborted(RuntimeError):
    """A collective that cannot complete: another partition's thread
    failed, or the partitions reached different collectives."""


class ShardGroup:
    """The rendezvous of the partitions' threads.

    The threads take turns, in partition order: a thread works until its
    next collective, posts its value there and hands the turn to the
    next partition's thread; the last one computes the reduction, once,
    over the values in partition order, and hands the turn back to the
    first, which goes on to its next collective. So every thread calls
    the collectives in the same order, and one thread runs at a time:
    host dispatch is serialised by the interpreter lock anyway, and P
    threads contending for it for every small torch operation ran 8
    partitions of an 8 x 8 box on the CPU 80 times slower than one
    device. Values alternate between two slot sets per collective, so a
    thread that has left collective n cannot overwrite what a later one
    still reads of it. Since no two partitions launch at once, the
    kernel wrappers' plain `fn.launches += 1` counts every launch."""

    def __init__(self, n_parts: int):
        self.n_parts = n_parts
        self.reset()

    def reset(self):
        """Ready for a new run of the partitions' threads."""
        n = self.n_parts
        self._turn = [threading.Semaphore(0) for _ in range(n)]
        self._slots = [[None] * n, [None] * n]
        self._result = [None, None]
        self._arrived = [0, 0]
        self._gen = [0] * n
        self._finished = 0
        self._failed = False
        self._mismatch = False

    def begin(self, rank: int):
        """Wait for the thread's first turn (partition 0 starts)."""
        if rank:
            self._wait(rank)

    def _wait(self, rank: int):
        self._turn[rank].acquire()
        if self._failed or self._mismatch:
            raise ShardAborted(
                "the partitions reached different collectives"
                if self._mismatch
                else "another partition failed"
            )

    def _pass(self, rank: int):
        self._turn[(rank + 1) % self.n_parts].release()

    def _wake_all(self):
        for t in self._turn:
            t.release()

    def _meet(self, rank: int, value, op):
        if self._finished:
            self._mismatch = True
            self._wake_all()
            raise ShardAborted("the partitions reached different collectives")
        g = self._gen[rank]
        self._gen[rank] = g ^ 1
        self._slots[g][rank] = value
        self._arrived[g] = 1 if rank == 0 else self._arrived[g] + 1
        if rank == self.n_parts - 1 and op is not None:
            vals = self._slots[g]
            out = vals[0]
            for v in vals[1:]:
                out = op(out, v.to(out.device))
            self._result[g] = out
        self._pass(rank)
        self._wait(rank)
        if self._arrived[g] != self.n_parts:
            self._mismatch = True
            self._wake_all()
            raise ShardAborted("the partitions reached different collectives")
        return g

    def reduce(self, rank: int, v, op):
        """op(...op(v_0, v_1)..., v_{P-1}) over the partitions' values,
        on rank's device."""
        g = self._meet(rank, v, op)
        return self._result[g].to(v.device)

    def exchange(self, rank: int, bufs, offsets):
        """For each ring offset d, the buffer that partition (rank - d)
        mod P posted at that offset's position."""
        g = self._meet(rank, bufs, None)
        slots = self._slots[g]
        return [
            slots[(rank - d) % self.n_parts][i] for i, d in enumerate(offsets)
        ]

    def abort(self):
        """A thread failed: every waiting thread raises ShardAborted."""
        self._failed = True
        self._wake_all()

    def finish(self, rank: int):
        """The thread is done: the turn passes on."""
        self._finished += 1
        self._pass(rank)


def _or(a, b):
    return a | b


class ShardedComm:
    """Communication context of one partition's thread (orc_tpu's
    `ShardedComm`): `send_idx` / `recv_idx` are this partition's rows of
    the exchange plan, on its device."""

    def __init__(self, partition: Partition, send_idx, recv_idx, group, rank: int):
        self.partition = partition
        self.send_idx = send_idx  # per ring offset, [s_d] local rows
        self.recv_idx = recv_idx
        self.group = group
        self.rank = rank

    def refresh(self, x):
        """x [L, ...] with its halo slots filled with the owners'
        values (padded entries land in the trash slot)."""
        if not self.partition.offsets:
            return x
        bufs = [x[s] for s in self.send_idx]
        got = self.group.exchange(self.rank, bufs, self.partition.offsets)
        out = x.clone()
        for r, buf in zip(self.recv_idx, got):
            out[r] = buf.to(out.device)
        return out

    def axis_sum(self, v):
        return self.group.reduce(self.rank, v, torch.add)

    def axis_min(self, v):
        return self.group.reduce(self.rank, v, torch.minimum)

    def axis_max(self, v):
        if v.dtype == torch.bool:
            return self.group.reduce(self.rank, v, _or)
        return self.group.reduce(self.rank, v, torch.maximum)


def make_comms(partition: Partition, group: ShardGroup):
    """One ShardedComm per partition, its exchange rows on its device."""
    comms = []
    for p, dev in enumerate(partition.devices):
        rows = lambda tabs: tuple(  # noqa: E731
            torch.tensor(t[p], dtype=torch.long, device=dev) for t in tabs
        )
        comms.append(
            ShardedComm(
                partition, rows(partition.send_idx), rows(partition.recv_idx),
                group, p,
            )
        )
    return comms


def _device_ctx(dev: torch.device):
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def run_partitions(
    devices: Sequence[torch.device], work: Callable, group: ShardGroup
):
    """work(rank) in one thread per partition, each inside its device's
    context, meeting at `group`; returns the results in partition order.
    The first failure (not a collective it aborted) is re-raised once
    every thread has ended."""
    n = len(devices)
    group.reset()
    results = [None] * n
    errors = [None] * n

    def body(rank):
        try:
            group.begin(rank)
            with _device_ctx(devices[rank]):
                results[rank] = work(rank)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[rank] = e
            group.abort()
        finally:
            group.finish(rank)

    threads = [
        threading.Thread(target=body, args=(r,), daemon=True) for r in range(n)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        first = next((e for e in failed if not isinstance(e, ShardAborted)), failed[0])
        raise first
    return results


# --- scatter / gather ----------------------------------------------------


def _map_tree(fn, tree):
    """fn over the array leaves of a tree of tuples, lists, dataclasses
    (FlowState, TurbState), tensors, numpy arrays and None."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, t) for t in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree,
            **{
                f.name: _map_tree(fn, getattr(tree, f.name))
                for f in dataclasses.fields(tree)
            },
        )
    return fn(tree)


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _scatter_host(partition: Partition, arr) -> np.ndarray:
    """Global [C, ...] -> stacked local [P, L, ...] numpy (orc_tpu's
    host-side scatter: owned slots take their cells' values, every other
    slot 0)."""
    og = partition.owned_global.astype(np.int64)
    om = partition.owned_mask
    arr = _host(arr)
    out = np.zeros(og.shape + arr.shape[1:], dtype=arr.dtype)
    out[om] = arr[og[om]]
    return out


def scatter_tree(partition: Partition, tree):
    """A tree of global [C, ...] arrays -> one tree of local [L, ...]
    tensors per partition, on its device (host-side scatter)."""
    stacked = _map_tree(lambda a: _scatter_host(partition, a), tree)
    return [
        _map_tree(lambda a: torch.from_numpy(a[p]).to(dev), stacked)
        for p, dev in enumerate(partition.devices)
    ]


def gather_tree(partition: Partition, trees, n_cells: int, device=None):
    """One tree of local [L, ...] tensors per partition -> the tree of
    global [C, ...] tensors, on `device` (default: partition 0's)."""
    og = partition.owned_global.astype(np.int64)
    om = partition.owned_mask
    device = device if device is not None else partition.devices[0]
    leaves = [[] for _ in trees]

    def collect(p):
        def f(a):
            leaves[p].append(_host(a))
            return a

        return f

    for p, t in enumerate(trees):
        _map_tree(collect(p), t)
    it = iter(range(len(leaves[0])))

    def ga(_):
        i = next(it)
        first = leaves[0][i]
        out = np.zeros((n_cells,) + first.shape[1:], dtype=first.dtype)
        for p in range(len(trees)):
            out[og[p][om[p]]] = leaves[p][i][om[p]]
        return torch.from_numpy(out).to(device)

    return _map_tree(ga, trees[0])


def scatter_state(partition: Partition, state: FlowState):
    """Global FlowState [C] -> one local FlowState [L] per partition
    (interop.flow_states_from_numpy of orc_tpu's stacked [P, L] layout).
    A stored flux (face-indexed, not cell-indexed) is dropped; the
    sharded FC runner re-seeds it per partition from the fields. The
    component-major mom_diag [3,C] goes through cell-major for the
    scatter."""
    from orc_tpu_torch.interop import flow_states_from_numpy

    return flow_states_from_numpy(
        _scatter_host(partition, state.vel),
        _scatter_host(partition, state.p),
        np.moveaxis(_scatter_host(partition, state.mom_diag.T), -1, 1),
        devices=partition.devices,
    )


def gather_state(partition: Partition, local, n_cells: int, device=None) -> FlowState:
    """One local FlowState [L] per partition -> the global FlowState [C]
    (on `device`, default partition 0's). The stored SIMPLE_FC flux is
    indexed by each partition's local faces and has no global numbering:
    it is dropped, and solve_steady re-seeds it from the fields when a
    warm-started FC run needs one."""
    vel, p, md = gather_tree(
        partition, [(s.vel, s.p, s.mom_diag.T) for s in local], n_cells, device
    )
    return FlowState(vel=vel, p=p, mom_diag=md.T.contiguous())


def _refresh_state(comm, state: FlowState) -> FlowState:
    """State with its halo slots refreshed: the FC initial flux reads
    neighbour values, so ghost slots must hold remote data first."""
    return dataclasses.replace(
        state,
        vel=comm.refresh(state.vel),
        p=comm.refresh(state.p),
        mom_diag=_refresh_rows(comm, state.mom_diag),
    )


# --- the sharded solvers ---------------------------------------------------


def _partition_devices(mesh, n_devices, devices):
    """The device of each partition: `devices` as given; else one per
    visible card for a CUDA mesh (n_devices beyond them is cut to them,
    as orc_tpu's jax.devices()[:n]); else n_devices partitions on the
    mesh's device."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if mesh.device.type == "cuda":
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return cards[: n_devices or len(cards)]
    return [mesh.device] * (n_devices or 1)


def slab_kernel_box(mesh, partition: Partition, cols):
    """The box of each slab partition's window for the tiled assembly
    kernels (`fused_assembly.kernel_box`): the global box
    (fused_assembly.box_dims) cut along its slowest axis to the planes
    that hold the window's rows, row0 its first row's place in its plane.
    A window whose owned range does not start on a plane starts inside
    its first plane; the trash row ends it. None when the ghost layers
    are no plane deep (or the partition is no slab)."""
    from orc_tpu_torch.ops.fused_assembly import box_dims

    dims = list(box_dims(cols, mesh.n_cells))
    axes = [a for a, d in enumerate(dims) if d > 1]
    if not axes or partition.h_max != 0:
        return None
    slow = axes[-1]
    plane = int(np.prod([dims[a] for a in axes[:-1]], dtype=np.int64))
    H = max(abs(int(d)) for d in mesh.neighbor_offsets)
    if H != plane:
        return None
    L = partition.local_size
    owned = partition.c_max - 2 * H  # the slab partitioner's c_max
    boxes = []
    for p in range(partition.n_parts):
        row0 = (p * owned - H) % plane
        dims[slow] = -(-(row0 + L) // plane)
        boxes.append((*dims, row0))
    return tuple(boxes)


def sharded_kernel_asm(mesh, table, settings, partition, use_ck, use_fc):
    """(cols, AsmSpec, one kernel box per partition) of the assembly
    kernels on the partitions, or None: orc_tpu's gate on the global mesh
    with `sharded=True` (gg off), for the slab partitions of a (c,k) step
    on CUDA devices (`slab_kernel_box`). Raises where the gate takes the
    kernels and the windows form no box, rather than run their plain
    versions on the card."""
    from orc_tpu_torch.solver.simple import _kernel_asm_spec

    if (
        not use_ck
        or partition.local_meshes[0].neighbor_offsets is None
        or any(d.type != "cuda" for d in partition.devices)
    ):
        return None
    spec = _kernel_asm_spec(
        mesh, table, settings, ck=True, fc=use_fc, sharded=True
    )
    if spec is None:
        return None
    boxes = slab_kernel_box(mesh, partition, spec[0])
    if boxes is None:
        raise ValueError(
            "the assembly kernels take this mesh, but its partitions' windows "
            "form no box (slab partitions with ghost layers one plane deep)"
        )
    return (*spec, boxes)


def _mg_hierarchies(mesh, table, settings, mu, devices):
    """orc_tpu's MULTIGRID hierarchy on the GLOBAL mesh, per distinct
    partition device: geometric on a box (host levels, no tensors),
    else algebraic from the global diffusion system."""
    if settings.matrix_solver.solver_type != SolutionMethod.MULTIGRID:
        return {}
    from orc_tpu_torch.solver.gmg import build_gmg_hierarchy, infer_box_dims

    dims = (
        infer_box_dims(mesh.neighbor_offsets, mesh.n_cells)
        if mesh.neighbor_offsets is not None
        else None
    )
    if dims is not None:
        h = build_gmg_hierarchy(dims, mesh.neighbor_offsets, settings.matrix_solver)
        return {d: h for d in devices} if h else {}
    from orc_tpu_torch.ops.assembly import diffusion_system
    from orc_tpu_torch.ops.fields import device_bc, face_bc
    from orc_tpu_torch.solver.amg import build_hierarchy_from_matrix

    z = device_bc(table, dtype=mesh.dtype, device=mesh.device)
    diff = diffusion_system(
        mesh, face_bc(mesh, *z), torch.tensor(mu, dtype=mesh.dtype, device=mesh.device)
    )
    args = (
        diff.diag.cpu().numpy(), diff.off.cpu().numpy(),
        mesh.cell_neighbors.cpu().numpy(), settings.matrix_solver,
    )
    return {d: build_hierarchy_from_matrix(*args, device=d) for d in set(devices)}


def _mg_extras(partition: Partition, hierarchies):
    """Per partition: {} or orc_tpu's sharded MULTIGRID extras, the
    hierarchy and the partition's (owned_mask, owned_global) rows."""
    out = []
    for p, dev in enumerate(partition.devices):
        if not hierarchies:
            out.append({})
            continue
        out.append(
            dict(
                mg_hierarchy=hierarchies[dev],
                mg_owned=(
                    torch.tensor(partition.owned_mask[p], device=dev),
                    torch.tensor(partition.owned_global[p], device=dev),
                ),
            )
        )
    return out


def make_sharded_step(
    partition: Partition,
    settings: NumericalSettings,
    n_steps: int = 1,
    use_ck: bool = False,
    n_zones: int = 0,
    mg_hierarchy=None,
    maybe_singular: bool = True,
    use_fc: bool = False,
    transient=None,  # (dt, inner_iterations) -> implicit time marching
    kernel_asm=None,  # (cols, AsmSpec, boxes) -> fused assembly kernels
):
    """The n-step sharded SIMPLE runner (orc_tpu's `make_sharded_step`).

    Returns run(local_states, zc, zs, zv, rho, mu) -> (local_states,
    StepMetrics of [n_steps]-leading tensors, the same on every
    partition: partition 0's). Each call runs the partitions' steps in
    one thread each.

    `transient=(dt, inner_iterations)` makes each of the n_steps one
    implicit-Euler time step (inertia rho V/dt from the partition's cell
    volumes; metrics of each step's last inner iteration). `use_ck` runs
    the (c,k) step, whose neighbour shifts read the refreshed ghost
    layers of slab partitions; `mg_hierarchy` is {device: hierarchy} of
    MULTIGRID runs (the fine smoother distributed, the coarse correction
    replicated). Steady float32 runs accumulate the state with Kahan
    compensation (settings.compensated_state), as solve_steady does."""
    from orc_tpu_torch.ops.assembly import diffusion_system
    from orc_tpu_torch.ops.ck_ops import build_ck_geometry, ck_bc, ck_diffusion
    from orc_tpu_torch.ops.fields import face_bc
    from orc_tpu_torch.solver import fc as fc_step
    from orc_tpu_torch.solver.simple import (
        _run_chunk,
        ck_simple_step,
        initial_flux,
        simple_step,
    )

    if settings.matrix_solver.solver_type == SolutionMethod.MULTIGRID:
        if not mg_hierarchy:
            raise ValueError(
                "sharded MULTIGRID needs a host-built hierarchy: "
                "solver/gmg.py (structured) or solver/amg.py (algebraic, "
                "built on the GLOBAL mesh)"
            )
    group = ShardGroup(partition.n_parts)
    comms = make_comms(partition, group)
    extras = _mg_extras(partition, mg_hierarchy or {})
    cks = (
        [build_ck_geometry(m, n_zones) for m in partition.local_meshes]
        if use_ck
        else None
    )

    def work(rank, state, zones, rho, mu):
        lmesh, comm = partition.local_meshes[rank], comms[rank]
        zc, zs, zv = (z.to(lmesh.device) for z in zones)
        mu_t = torch.tensor(mu, dtype=lmesh.dtype, device=lmesh.device)
        if use_ck:
            ck = cks[rank]
            bc = ck_bc(ck, zc, zs, zv)
            ck_diff = ck_diffusion(lmesh, ck, bc, mu_t)
            if use_fc and state.flux is None:
                state = dataclasses.replace(
                    state,
                    flux=fc_step.ck_initial_flux(
                        lmesh, ck, bc, settings, _refresh_state(comm, state)
                    ),
                )
            step_fn = fc_step.ck_simple_step_fc if use_fc else ck_simple_step

            kasm = (
                None if kernel_asm is None else (*kernel_asm[:2], kernel_asm[2][rank])
            )

            def step1(s, inertia):
                return step_fn(
                    lmesh, ck, zc, zs, zv, settings, rho, mu, ck_diff, s,
                    extras[rank], inertia=inertia, comm=comm,
                    kernel_asm=kasm, maybe_singular=maybe_singular,
                )

        else:
            diff = diffusion_system(lmesh, face_bc(lmesh, zc, zs, zv), mu_t)
            if use_fc and state.flux is None:
                state = dataclasses.replace(
                    state,
                    flux=initial_flux(
                        lmesh, zc, zs, zv, settings, _refresh_state(comm, state)
                    ),
                )
            fm_step = fc_step.simple_step_fc if use_fc else simple_step

            def step1(s, inertia):
                return fm_step(
                    lmesh, zc, zs, zv, settings, rho, mu, diff, s,
                    extras[rank], comm=comm, inertia=inertia,
                    maybe_singular=maybe_singular,
                )

        if transient is None:
            return _run_chunk(lambda s: step1(s, None), state, settings, n_steps)
        dt_t, inner_it = transient
        rv_dt = rho * lmesh.cell_volume / dt_t
        last = []
        for _ in range(n_steps):
            inertia = (rv_dt, state.vel)
            for _ in range(inner_it):
                state, m = step1(state, inertia)
            last.append(m)
        return state, StepMetrics(
            **{f: torch.stack([getattr(m, f) for m in last]) for f in _metric_names()}
        )

    def run(local, zc, zs, zv, rho, mu):
        out = run_partitions(
            partition.devices,
            lambda r: work(r, local[r], (zc, zs, zv), rho, mu),
            group,
        )
        for dev in set(partition.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return [s for s, _ in out], out[0][1]

    return run


def _use_ck(settings, partition, use_ck, n_local):
    """orc_tpu's choice of the per-partition step."""
    from orc_tpu_torch.solver.simple import CK_AUTO_MAX_CELLS

    ck_grad_ok = settings.gradient_reconstruction in (
        GradientReconstruction.GREEN_GAUSS_CELL,
        GradientReconstruction.LEAST_SQUARES,
    )
    if use_ck is True and not ck_grad_ok:
        raise ValueError(
            "use_ck=True requires green_gauss_cell or least_squares "
            f"gradients (the ck-direct step does not implement "
            f"{settings.gradient_reconstruction})"
        )
    if use_ck == "auto":
        return (
            ck_grad_ok
            and partition.local_meshes[0].neighbor_offsets is not None
            and n_local <= CK_AUTO_MAX_CELLS
        )
    return bool(use_ck)


def _setup(mesh, table, settings, mu, n_devices, devices, partition_method,
           use_ck, state):
    """What both sharded solvers build before their loop: the partition, the
    step choice, the zone tables, the scattered state, the hierarchies
    and maybe_singular."""
    from orc_tpu_torch.ops.fields import device_bc
    from orc_tpu_torch.solver.simple import (
        initial_state,
        table_has_pressure_bc,
        table_maybe_singular,
    )

    table.validate_supported()
    use_fc = settings.resolved_coupling() == PressureVelocityCoupling.SIMPLE_FC
    devs = _partition_devices(mesh, n_devices, devices)
    partition = partition_mesh(mesh, len(devs), method=partition_method, devices=devs)
    use_ck = _use_ck(settings, partition, use_ck, partition.local_size)
    zones = device_bc(table, dtype=mesh.dtype, device=mesh.device)
    if state is None:
        state = initial_state(mesh)
    maybe_singular = (
        not table_has_pressure_bc(table) if use_fc else table_maybe_singular(table)
    )
    return dict(
        partition=partition,
        use_fc=use_fc,
        use_ck=use_ck,
        zones=zones,
        local=scatter_state(partition, state),
        mg=_mg_hierarchies(mesh, table, settings, mu, partition.devices),
        maybe_singular=maybe_singular,
        kernel_asm=sharded_kernel_asm(
            mesh, table, settings, partition, use_ck, use_fc
        ),
    )


def _concat(history):
    if len(history) == 1:
        return history[0]
    return StepMetrics(
        **{
            f: torch.cat([getattr(h, f) for h in history])
            for f in _metric_names()
        }
    )


def solve_steady_sharded(
    mesh,
    table: BoundaryTable,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    state: Optional[FlowState] = None,
    iterations: int = 10,
    reporting_interval: int = 1,
    n_devices: Optional[int] = None,
    verbose: bool = True,
    check_divergence: bool = True,
    partition_method: str = "auto",
    use_ck: str | bool = "auto",
    devices: Optional[Sequence] = None,
):
    """Multi-partition drop-in for solve_steady: partitions the mesh (one
    partition per visible card for a CUDA mesh, n_devices of them on the
    CPU; `devices` places them explicitly, repeats allowed), runs the
    sharded SIMPLE loop and returns the global FlowState and the
    per-chunk metrics.

    partition_method: "slab" (ghost layers, shift SpMV on structured
    meshes), "rcb", or "auto". use_ck: "auto" takes the (c,k) step when
    the partitions kept the structured offsets and the gradients are
    Green-Gauss cell or least squares, True forces it, False takes the
    face-major step. On slab partitions of a CUDA box the (c,k) step runs
    the fused assembly kernels on each partition's window
    (`sharded_kernel_asm`)."""
    s = _setup(
        mesh, table, settings, mu, n_devices, devices, partition_method,
        use_ck, state,
    )
    partition, local = s["partition"], s["local"]
    n = partition.n_parts
    reporting_interval = max(1, min(reporting_interval, iterations))

    def make(k):
        return make_sharded_step(
            partition, settings, n_steps=k, use_ck=s["use_ck"],
            n_zones=len(table.zone_ids), mg_hierarchy=s["mg"],
            maybe_singular=s["maybe_singular"], use_fc=s["use_fc"],
            kernel_asm=s["kernel_asm"],
        )

    run = make(reporting_interval)
    history = []
    done = 0
    t0 = time.perf_counter()
    while done < iterations:
        k = min(reporting_interval, iterations - done)
        if k != reporting_interval:
            run = make(k)
        local, metrics = run(local, *s["zones"], rho, mu)
        done += k
        history.append(metrics)
        if verbose:
            dt_ms = (time.perf_counter() - t0) * 1e3 / k
            t0 = time.perf_counter()
            va = metrics.vel_avg[-1].cpu().tolist()
            print(
                f"[{n} devices] Iteration {done}: avg velocity = "
                f"({va[0]:.2e}, {va[1]:.2e}, {va[2]:.2e})\t"
                f"vel corr = {float(metrics.vel_corr_norm[-1]):.2e}\t"
                f"p corr = {float(metrics.p_corr_norm[-1]):.2e}\t"
                f"ms/iter = {dt_ms:.3g}"
            )
        if check_divergence and bool(torch.any(metrics.diverged)):
            raise SolverDivergedError(done)
    return gather_state(partition, local, mesh.n_cells, mesh.device), history


def solve_transient_sharded(
    mesh,
    table: BoundaryTable,
    settings: NumericalSettings,
    rho: float,
    mu: float,
    dt: float,
    n_steps: int,
    inner_iterations: int = 20,
    state: Optional[FlowState] = None,
    n_devices: Optional[int] = None,
    verbose: bool = True,
    check_divergence: bool = True,
    partition_method: str = "auto",
    use_ck: str | bool = "auto",
    report_interval: int = 0,
    devices: Optional[Sequence] = None,
):
    """Multi-partition drop-in for solver/transient.solve_transient:
    implicit-Euler time marching with per-partition inertia from the
    local cell volumes, a halo refresh before every neighbour read and
    completed reductions in every solve. Returns the global FlowState at
    t = n_steps*dt and the per-time-step metrics (each step's last inner
    iteration), gathered over chunks of `report_interval` steps (all
    steps in one chunk when 0)."""
    s = _setup(
        mesh, table, settings, mu, n_devices, devices, partition_method,
        use_ck, state,
    )
    partition, local = s["partition"], s["local"]
    n = partition.n_parts
    chunk = n_steps if report_interval <= 0 else min(report_interval, n_steps)

    def make(k):
        return make_sharded_step(
            partition, settings, n_steps=k, use_ck=s["use_ck"],
            n_zones=len(table.zone_ids), mg_hierarchy=s["mg"],
            maybe_singular=s["maybe_singular"], use_fc=s["use_fc"],
            transient=(dt, inner_iterations), kernel_asm=s["kernel_asm"],
        )

    run = make(chunk)
    history = []
    done = 0
    t0 = time.perf_counter()
    while done < n_steps:
        k = min(chunk, n_steps - done)
        if k != chunk:
            run = make(k)
        local, metrics = run(local, *s["zones"], rho, mu)
        done += k
        history.append(metrics)
        if verbose:
            va = metrics.vel_avg[-1].cpu().tolist()
            dt_ms = (time.perf_counter() - t0) * 1e3 / k
            t0 = time.perf_counter()
            print(
                f"[{n} devices] t = {done * dt:.4g} ({done} steps): avg "
                f"velocity = ({va[0]:.2e}, {va[1]:.2e}, {va[2]:.2e})  "
                f"ms/step = {dt_ms:.3g}"
            )
        if check_divergence and bool(torch.any(metrics.diverged)):
            raise SolverDivergedError(done)
    return (
        gather_state(partition, local, mesh.n_cells, mesh.device),
        _concat(history),
    )
