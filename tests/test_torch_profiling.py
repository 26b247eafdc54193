"""``utils/profiling.py``'s profiles: ``capture_trace`` writes a Chrome
trace that names a ``trace()`` span, and ``device_busy`` counts the union of
the device's intervals, so operations that overlap count once.
"""

import json

import pytest
import torch

from protgram_directgcn_torch.utils import profiling as t_prof


def test_capture_trace_names_the_trace_range(tmp_path):
    with t_prof.capture_trace(tmp_path / "prof", device="cpu") as prof:
        with t_prof.trace("zoo_forward"):
            (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "zoo_forward" for e in events)
    busy = t_prof.device_busy(prof, 1.0)
    assert busy["busy_share"] is None and busy["wall_seconds"] == 1.0


class _Event:
    """A raw profiler event as ``device_busy`` reads it."""

    def __init__(self, start, end, device=True, annotation=False):
        self._start, self._end = start, end
        self._device = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
        self._annotation = annotation

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation


class _Profile:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda _self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


@pytest.mark.parametrize("intervals,busy_ns", [
    ([(0, 100), (200, 300)], 200),  # disjoint
    ([(0, 100), (50, 150)], 150),  # overlapping, two streams
    ([(0, 300), (100, 200)], 300),  # nested
    ([(0, 100), (100, 200), (150, 250), (400, 410)], 260),  # touching, a chain, a gap
])
def test_device_busy_counts_overlaps_once(intervals, busy_ns):
    events = [_Event(a, b) for a, b in intervals]
    # Host operations and the device's annotation ranges are not device time.
    events += [_Event(0, 10_000, device=False), _Event(0, 10_000, annotation=True)]
    busy = t_prof.device_busy(_Profile(events), 1e-6)
    assert busy["device_seconds"] == busy_ns / 1e9
    assert busy["busy_share"] == pytest.approx(busy_ns / 1e3)


@pytest.mark.parametrize("intervals", [[(5, 9), (0, 3), (2, 4)], [(3, 3)], []])
def test_union_ns_is_order_free(intervals):
    points = {t for a, b in intervals for t in range(a, b)}
    assert t_prof.union_ns(intervals) == len(points)
