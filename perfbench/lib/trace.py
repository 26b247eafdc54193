"""Reading ``torch.profiler`` traces of the traced window.

The metrics' window is traced with device activity alone, so that the
profiler adds no host work a step: its length is the host clock between two
synchronisations, and its device time is the union of the intervals in
which any device operation ran (operations that overlap, on two streams,
count once).  A second, short window traced with host activity too names
the idle gaps: each by the innermost host range open at its midpoint, which
says what the host was doing while the card waited.  That window is marked
in its trace by two host ranges the harness opens after synchronising the
card (``OPEN_MARK``, ``CLOSE_MARK``), so its bounds and its events share the
profiler's clock.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

OPEN_MARK = "perfbench.traced_window.open"
CLOSE_MARK = "perfbench.traced_window.close"
_NO_RANGE = "(no host range open)"
_NAME_CHARS = 160


@dataclasses.dataclass
class Event:
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class TraceSummary:
    """What the per-layer readers take from a traced window."""

    window_s: float
    busy_s: float
    epochs: int  # steps completed inside the window
    device_ops: List[Event]  # device operations, clipped to the window
    gaps: List[Tuple[str, float]]  # idle gaps, longest first: (host range, seconds)

    @property
    def step_s(self) -> float:
        return self.window_s / self.epochs

    def kernel_seconds(self, names: Sequence[str]) -> float:
        """Summed device time of the operations whose name holds one of
        ``names``."""
        return sum(e.end_ns - e.start_ns for e in self.device_ops
                   if any(n in e.name for n in names)) / 1e9

    def kernel_launches(self) -> int:
        """Kernels run in the window (copies and sets left out)."""
        return sum(1 for e in self.device_ops if not _is_copy(e.name))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for e in self.device_ops:
            key = e.name[:_NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (e.end_ns - e.start_ns) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k[:_NAME_CHARS], v] for k, v in self.gaps[:top]]}


def _is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def union_intervals(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged, sorted, disjoint intervals covering the same points."""
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def summarize(device: Sequence[Event], host: Sequence[Event], window: Tuple[int, int],
              epochs: int, top_gaps: int = 10) -> TraceSummary:
    """The traced window's device time, device operations and longest idle
    gaps, from device and host events in one clock (ns)."""
    lo, hi = window
    clipped = [Event(e.name, max(e.start_ns, lo), min(e.end_ns, hi))
               for e in device if e.end_ns > lo and e.start_ns < hi]
    busy = union_intervals((e.start_ns, e.end_ns) for e in clipped)
    busy_ns = sum(b - a for a, b in busy)
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:top_gaps]
    starts = np.array([e.start_ns for e in host], dtype=np.int64)
    ends = np.array([e.end_ns for e in host], dtype=np.int64)
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (host[int(inside[np.argmin(ends[inside] - starts[inside])])].name
                if len(inside) else _NO_RANGE)
        named.append((name, (b - a) / 1e9))
    return TraceSummary(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9, epochs=epochs,
                        device_ops=clipped, gaps=named)


def _events(prof):
    """(device events, host events, window marks) of a finished profile.
    Reads the raw events: ``key_averages()`` builds the whole event tree in
    Python first, which is slow for tens of thousands of events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device: List[Event] = []
    host: List[Event] = []
    marks: Dict[str, int] = {}
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        ev = Event(e.name(), start, start + int(e.duration_ns()))
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append(ev)
        elif ev.name in (OPEN_MARK, CLOSE_MARK):
            marks[ev.name] = start
        else:
            host.append(ev)
    return device, host, marks


def device_window(prof, window_s: float, epochs: int) -> Optional[TraceSummary]:
    """Summary of a device-only profile that spans exactly the window of
    ``window_s`` seconds (host clock); None where it holds no device
    operation."""
    device, _, _ = _events(prof)
    if not device:
        return None
    busy = union_intervals((e.start_ns, e.end_ns) for e in device)
    return TraceSummary(window_s=window_s, busy_s=sum(b - a for a, b in busy) / 1e9,
                        epochs=epochs, device_ops=device, gaps=[])


def named_gaps(prof, top: int = 10) -> List[Tuple[str, float]]:
    """The longest idle gaps of a profile with host activity, between its
    window marks, each named by the host range open at its midpoint."""
    device, host, marks = _events(prof)
    if OPEN_MARK not in marks or CLOSE_MARK not in marks:
        return []
    return summarize(device, host, (marks[OPEN_MARK], marks[CLOSE_MARK]), 1, top).gaps
