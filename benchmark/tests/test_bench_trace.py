"""The trace reduction on synthetic profiler events: busy time is the
union of device intervals inside the window, per card; the device-side
mirrors of the harness's ranges are not operations; idle gaps are named
by the innermost span over them."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, a_us, b_us, dev=CUDA, idx=0):
    return SimpleNamespace(name=name, device_type=dev, device_index=idx,
                           time_range=SimpleNamespace(start=a_us, end=b_us))


def test_reduce_unions_intervals_and_skips_annotations():
    evs = [
        _ev(trace.WINDOW, 0, 1000, CPU),
        _ev("live.process_many", 100, 600, CPU),
        _ev("live.process_frames", 200, 500, CPU),
        _ev("live.process_many", 100, 600),          # the range's device mirror
        _ev("kernel_a", 250, 350), _ev("kernel_b", 300, 400),   # overlap: union 150
        _ev("kernel_c", 900, 1200),                  # clipped at the window's end: 100
        _ev("kernel_d", 0, 400, idx=1),              # another card
    ]
    tr = trace.reduce(evs, [0, 1], {"live.process_many", "live.process_frames"})
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s[0] == pytest.approx(250e-6) and tr.busy_s[1] == pytest.approx(400e-6)
    assert tr.busy_mean_s() == pytest.approx(325e-6)
    assert "live.process_many" not in tr.time_by_name()
    assert tr.time_matching(("kernel_a", "kernel_b")) == pytest.approx(200e-6)
    # card 0's idle: [0,250) between calls / pool / engine, [400,900) engine / pool / between
    assert sum(tr.gaps.values()) == pytest.approx((750e-6 + 600e-6) / 2)
    assert set(tr.gaps) <= {"between calls", "live.process_many", "live.process_frames"}
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] == "kernel_d" and len(b["idle_gaps"]) <= 10


def test_reduce_without_a_window_reads_nothing():
    assert trace.reduce([_ev("kernel_a", 0, 1)], [0], set()) is None
