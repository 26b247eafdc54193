"""The union-of-intervals reader of device time and the idle-gap names."""

import pytest

from perfbench.lib import trace
from perfbench.lib.trace import Event


def test_union_merges_overlaps_once():
    assert trace.union_intervals([(5, 8), (0, 3), (2, 4), (8, 9), (10, 12)]) == [
        (0, 4), (5, 9), (10, 12)]


def test_summarize_counts_overlap_once_and_names_gaps():
    device = [Event("k1", 0, 40), Event("k2", 20, 50), Event("Memcpy DtoH", 70, 80),
              Event("late", 95, 130)]
    host = [Event("step", 0, 100), Event("aten::item", 55, 69), Event("aten::mul", 81, 94)]
    s = trace.summarize(device, host, (0, 100), epochs=2)
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx((50 + 10 + 5) * 1e-9)  # clipped at the window's end
    assert s.step_s == pytest.approx(50e-9)
    assert s.kernel_launches() == 3
    assert s.kernel_seconds(("k1", "k2")) == pytest.approx(70e-9)  # own durations, summed
    # Gaps 50-70 (item open), 80-95 (mul open), longest first.
    assert [name for name, _ in s.gaps] == ["aten::item", "aten::mul"]
    assert s.gaps[0][1] == pytest.approx(20e-9)
    b = s.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(40e-9)]
    assert b["idle_gaps"][0][0] == "aten::item"


def test_gap_with_no_host_range():
    s = trace.summarize([Event("k", 0, 10)], [], (0, 30), epochs=1)
    assert s.gaps == [("(no host range open)", pytest.approx(20e-9))]
