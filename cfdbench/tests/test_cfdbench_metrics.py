"""Each per-layer metric reader on a small recorded trace; the trace
reduction (busy time, launches, idle gaps by host op)."""

import importlib
import json
from pathlib import Path

import pytest

from cfdbench.metrics import hbm_bytes
from cfdbench.run import MetricContext
from cfdbench.trace import Trace, reduce_events

ROOT = Path(__file__).resolve().parents[2]
DIMS = (1024, 1024, 1)
C = 1024 * 1024
SPMV = "void orc::shift_spmv_kernel<float, 4, false>(float const*)"
TILE = "void orc::jacobi_tile_kernel<float, 3, 4, false>(float const*)"
MOM = "void orc::fc_momentum_kernel<float, 2, 2>(orc::AsmCols<float>)"
PC = "void orc::fc_pc_kernel<float, 1>(orc::AsmCols<float>)"
ADD = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"
COPY = "Memcpy DtoH (Device -> Pageable)"


def recorded():
    """Two iterations: 100 SpMV launches of 10 us, one sweep call of
    40 us each, one of each assembly kernel, 300 adds of 20 us, one
    copy; busy 9 ms of a 10 ms window."""
    kernels = {
        SPMV: [100, 100 * 10e-6],
        TILE: [2, 2 * 40e-6],
        MOM: [2, 2 * 90e-6],
        PC: [2, 2 * 45e-6],
        ADD: [300, 300 * 20e-6],
        COPY: [2, 2e-6],
    }
    return Trace(kernels, busy_s=9e-3, window_s=10e-3, gaps={"aten::item": 1e-3})


def ctx():
    return MetricContext(recorded(), 2, DIMS, C, 4, [0.5, 9.0, 1.0, 0.25], 12.5)


PEAK = json.loads((ROOT / "cfdbench" / "peaks.json").read_text())["hbm_bytes_per_s"]


def expected():
    s = 4
    spmv = 100 * hbm_bytes.spmv_bytes(C, 4, 1, s) / 1e-3 / PEAK * 100
    smooth = 2 * hbm_bytes.sweep_bytes(C, 4, 3, s) / 80e-6 / PEAK * 100
    asm = 2 * (hbm_bytes.fc_momentum_bytes(C, 6, s) + hbm_bytes.fc_pc_bytes(C, 6, s)) / 270e-6 / PEAK * 100
    return {
        "idle_pct": 10.0,
        "launches_per_iter": 204.0,
        "plain_ms_per_iter": 1e3 * (300 * 20e-6 + 2e-6) / 2,
        "p_solve_residual": 0.75,
        "spmv_hbm_pct": spmv,
        "smooth_hbm_pct": smooth,
        "asm_hbm_pct": asm,
        "mesh_build_s": 12.5,
    }


@pytest.mark.parametrize("name", list(expected()))
def test_reader_on_recorded_trace(name):
    value = importlib.import_module(f"cfdbench.metrics.{name}").read(ctx())
    assert value == pytest.approx(expected()[name], rel=1e-12)


@pytest.mark.parametrize("name", ["spmv_hbm_pct", "smooth_hbm_pct", "asm_hbm_pct", "idle_pct", "launches_per_iter", "plain_ms_per_iter", "p_solve_residual"])
def test_reader_finds_nothing(name):
    empty = MetricContext(Trace({}, 0.0, 0.0, {}), 2, DIMS, C, 4, [], 1.0)
    assert importlib.import_module(f"cfdbench.metrics.{name}").read(empty) is None


def test_reduce_events():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 30.0, 40.0), ("k3", 100.0, 110.0)]
    host = [
        ("aten::sum", 0.0, 50.0),
        ("aten::item", 15.0, 45.0),
        ("cudaStreamSynchronize", 40.0, 95.0),
    ]
    t = reduce_events(device, host, 200e-6)
    assert t.kernels == {"k1": [2, pytest.approx(20e-6)], "k2": [1, pytest.approx(15e-6)], "k3": [1, pytest.approx(10e-6)]}
    assert t.busy_s == pytest.approx(40e-6)
    # Gaps 20-30 (inside aten::item) and 40-100 (cudaStreamSynchronize).
    assert t.gaps == {"aten::item": pytest.approx(10e-6), "cudaStreamSynchronize": pytest.approx(60e-6)}


def test_minus():
    a = recorded()
    b = Trace({SPMV: [40, 4e-4]}, 3e-3, 4e-3, {"aten::item": 2e-4})
    d = a.minus(b)
    assert d.kernels[SPMV] == [60, pytest.approx(6e-4)]
    assert d.busy_s == pytest.approx(6e-3) and d.window_s == pytest.approx(6e-3)
    assert d.gaps["aten::item"] == pytest.approx(8e-4)
