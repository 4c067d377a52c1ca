"""cfdbench.spans's reduction on a small recorded event list: device work
by the spans open at its launch (matched by correlation id), idle gaps
by the spans open when they began, extents, counts; and cfdbench.trace's
reduction of the same events (what the per-layer metrics read) equal to
its reduction without the spans in busy time, launches and idle time."""

import pytest

from cfdbench.spans import OUTSIDE, reduce_spans
from cfdbench.trace import reduce_events

ADD = "void at::native::vectorized_elementwise_kernel<4, add>"
SPMV = "void orc::shift_spmv_kernel<float, 4, false>"

#: Host events (name, start_us, end_us, id): a step with two phases, the
#: second holding a counted read, and the launches of four device ops.
HOST = [
    ("orc.step", 0.0, 100.0, 1),
    ("orc.momentum_assembly", 1.0, 30.0, 2),
    ("aten::add", 2.0, 6.0, 3),
    ("cudaLaunchKernel", 3.0, 5.0, 50),
    ("orc.pressure_solve", 31.0, 99.0, 4),
    ("cudaLaunchKernel", 32.0, 34.0, 51),
    ("cudaLaunchKernel", 35.0, 37.0, 52),
    ("orc.sync.all_done", 60.0, 90.0, 5),
    ("aten::item", 61.0, 89.0, 6),
    ("cudaLaunchKernel", 120.0, 121.0, 53),
]
#: Device events (name, start_us, end_us, id): the add runs 10-35, past
#: the end of the momentum assembly on the host (30); the two SpMVs
#: 40-50 and 50-70, launched in the pressure solve; the last op 130-140,
#: launched outside any span.
DEVICE = [
    (ADD, 10.0, 35.0, 50),
    (SPMV, 40.0, 50.0, 51),
    (SPMV, 50.0, 70.0, 52),
    (ADD, 130.0, 140.0, 53),
]


def test_device_time_goes_to_the_spans_open_at_launch():
    t = reduce_spans(DEVICE, HOST)
    assert t.device == pytest.approx({"orc.momentum_assembly": 25e-6, "orc.pressure_solve": 30e-6, OUTSIDE: 10e-6})
    assert t.device_incl == pytest.approx(
        {"orc.step": 55e-6, "orc.momentum_assembly": 25e-6, "orc.pressure_solve": 30e-6}
    )


def test_idle_gaps_go_to_the_spans_open_when_they_began():
    t = reduce_spans(DEVICE, HOST)
    # Gap 35-40 begins in the pressure solve, after the momentum
    # assembly's host end; 70-130 inside the read, at any depth in the
    # pressure solve and the step.
    assert t.idle == pytest.approx({"orc.pressure_solve": 5e-6, "orc.sync.all_done": 60e-6})
    assert t.idle_incl == pytest.approx(
        {"orc.step": 65e-6, "orc.pressure_solve": 65e-6, "orc.sync.all_done": 60e-6}
    )


def test_extent_reaches_the_end_of_the_work_launched_inside():
    t = reduce_spans(DEVICE, HOST)
    assert t.extent["orc.step"] == pytest.approx(100e-6)
    assert t.extent["orc.momentum_assembly"] == pytest.approx(34e-6)  # 1 .. the add's end at 35
    assert t.extent["orc.pressure_solve"] == pytest.approx(68e-6)  # its own end, 99
    assert t.count == {
        "orc.step": 1, "orc.momentum_assembly": 1, "orc.pressure_solve": 1, "orc.sync.all_done": 1,
    }


def test_minus_takes_one_call_from_another():
    t = reduce_spans(DEVICE, HOST)
    d = t.minus(reduce_spans(DEVICE[:1], HOST))
    assert d.device_incl["orc.pressure_solve"] == pytest.approx(30e-6)
    assert d.device_incl["orc.momentum_assembly"] == pytest.approx(0.0)
    assert d.count["orc.step"] == 0


def test_trace_reduction_reads_the_same_busy_time_and_launches_with_spans():
    bare = [h[:3] for h in HOST if not h[0].startswith("orc.")]
    with_spans = reduce_events([d[:3] for d in DEVICE], [h[:3] for h in HOST], 200e-6)
    without = reduce_events([d[:3] for d in DEVICE], bare, 200e-6)
    assert with_spans.kernels == without.kernels
    assert with_spans.busy_s == without.busy_s
    assert sum(with_spans.gaps.values()) == pytest.approx(sum(without.gaps.values()))
