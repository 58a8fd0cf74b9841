"""The reader of K6's device time (`metrics/k6_device_ms.py`) on
hand-worked traces."""

import pytest

from bench_port import harness


def test_k6_device_ms_sums_both_kernels_per_unit():
    read = harness.reader("k6_device_ms.train")
    events = [(0, 30, "void (anonymous namespace)::wgrad_kernel<8, 4>(float const*, Geo, int)"),
              (30, 40, "void (anonymous namespace)::wgrad_reduce_kernel<32>(float const*, float*)"),
              (40, 90, "void cudnn::cnn::wgrad2d_grouped_direct_kernel<true, true, int>(...)"),
              (90, 95, "void at::native::reduce_kernel<512, 1>(...)")]
    # 30 + 10 us of K6 over 2 steps
    assert read({"device_events": events, "traced_units": 2}) == pytest.approx(0.02)


def test_k6_device_ms_is_left_out_without_k6():
    read = harness.reader("k6_device_ms.train-half")
    events = [(0, 50, "void cudnn::cnn::wgrad2d_grouped_direct_kernel<true, true, int>(...)")]
    assert read({"device_events": events, "traced_units": 2}) is None
    assert read({"device_events": [], "traced_units": 2}) is None
