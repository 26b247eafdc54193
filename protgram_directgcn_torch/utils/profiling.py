"""Profiling and performance instrumentation.

Port of protgram_directgcn_tpu/utils/profiling.py onto ``torch.profiler``:

- ``trace(name)``: the port's one span primitive.  A span records only
  while a torch profiler runs (or where it is opened with ``always=True``):
  it opens a profiler range (``record_function``'s), so a profiler's trace shows it on
  the profiler's own clock beside the device's operations, and appends
  ``Span(name, parent, start_ns, end_ns)`` (``time.perf_counter_ns``) to an
  in-memory store, read by ``spans()`` and cleared by ``reset_spans()``.  A
  span's parent is the index of the recording span open when it started,
  so its self time is its duration less its children's (``self_ns``).
  Where it does not record, ``trace`` returns one shared no-op context
  after a read of torch's own flag: no range and no clock read.
  ``trace_outside(name)`` wraps a call that may stop or start a profiler:
  no range stays open across it;
- ``capture_trace(dir)``: ``torch.profiler`` over the CPU and, where CUDA
  is present, the card's kernels, written as a Chrome trace;
- ``profiler`` and ``device_busy``: a profile of the device's activity,
  and its device time beside its wall time (the device's busy share).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.autograd.profiler as _autograd_profiler

from protgram_directgcn_torch.utils.io import ensure_dir, logger


class Span(NamedTuple):
    name: str
    parent: int  # index in the store of the span open when it started; -1: none
    start_ns: int
    end_ns: int  # -1 while the span is open

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


# The profiler's range in C++ (what ``torch.profiler.record_function``
# opens through two dispatched ops, at some ten times the host time).
_RANGE = torch._C._profiler._RecordFunctionFast
_SPANS: List[Span] = []
_OPEN: List["_Recording"] = []  # the recording spans now open, innermost last
_generation = 0  # counts the resets: a span open across one is not written back


class _Recording:
    __slots__ = ("name", "index", "generation", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def open_range(self) -> None:
        self.range = _RANGE(self.name)
        self.range.__enter__()

    def close_range(self) -> None:
        if self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None

    def __enter__(self):
        self.open_range()
        return self.start()

    def start(self):
        self.index, self.generation = len(_SPANS), _generation
        parent = _OPEN[-1].index if _OPEN else -1
        _SPANS.append(Span(self.name, parent, time.perf_counter_ns(), -1))
        _OPEN.append(self)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.generation == _generation and self in _OPEN:
            _SPANS[self.index] = _SPANS[self.index]._replace(end_ns=end)
            del _OPEN[_OPEN.index(self):]
        self.close_range()
        return False


class _Outside:
    """A span around code that may stop or start a profiler: see
    :func:`trace_outside`."""

    __slots__ = ("span", "held")

    def __init__(self, span: Optional[_Recording]):
        self.span = span

    def __enter__(self):
        self.held = [s for s in _OPEN if s.range is not None]
        for s in reversed(self.held):
            s.close_range()
        if self.span is not None:
            self.span.start()
        return self

    def __exit__(self, *exc):
        if self.span is not None:
            self.span.__exit__(*exc)
        for s in self.held:
            s.open_range()
        return False


_NO_SPAN = contextlib.nullcontext()


def trace(name: str, always: bool = False):
    """A span named ``name``: recorded while a torch profiler runs, or
    always with ``always=True`` (for set-up stages, once a level or a
    process); otherwise the shared no-op context."""
    if always or _autograd_profiler._is_profiler_enabled:
        return _Recording(name)
    return _NO_SPAN


def trace_outside(name: str):
    """A span around a call into code that may stop or start a profiler
    (a metrics logger's callback, say).  A profiler range must not stay
    open across a profiler's stop: closed under the next profiler, it
    writes into the stopped one's freed records.  So the ranges of the open
    spans close for the call and open again after it, and the span itself
    is recorded in the store (under a profiler) with no range."""
    enabled = _autograd_profiler._is_profiler_enabled
    if not (enabled or _OPEN):
        return _NO_SPAN
    return _Outside(_Recording(name) if enabled else None)


def spans() -> List[Span]:
    """The recorded spans, in the order they started."""
    return _SPANS


def reset_spans() -> None:
    global _generation
    _generation += 1
    _SPANS.clear()
    _OPEN.clear()


def span_seconds(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Seconds of the closed spans by name (spans of one name summed);
    ``names`` keeps those names only."""
    keep = None if names is None else set(names)
    out: Dict[str, float] = {}
    for s in _SPANS:
        if s.end_ns >= 0 and (keep is None or s.name in keep):
            out[s.name] = out.get(s.name, 0.0) + s.seconds
    return out


def self_ns(store: Optional[List[Span]] = None) -> List[int]:
    """Each closed span's duration less its closed children's (ns)."""
    store = _SPANS if store is None else store
    own = [s.end_ns - s.start_ns if s.end_ns >= 0 else 0 for s in store]
    for s in store:
        if s.parent >= 0 and s.end_ns >= 0:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def profiler(device: Union[str, torch.device] = "cuda") -> torch.profiler.profile:
    """``torch.profiler`` over the device's own activity: on the card its
    kernels and copies only (what ``device_busy`` reads; leaving out the
    CPU's operator events keeps the profiler's cost per launch low), on the
    CPU its operators."""
    act = torch.profiler.ProfilerActivity
    cuda = torch.device(device).type == "cuda"
    return torch.profiler.profile(activities=[act.CUDA if cuda else act.CPU])


@contextlib.contextmanager
def capture_trace(log_dir: Union[str, os.PathLike],
                  device: Optional[Union[str, torch.device]] = None):
    """Profile the block and write ``log_dir/trace.json`` (a Chrome trace,
    which Perfetto opens).  ``device``: the card's kernels are traced too
    where it is CUDA (default: where CUDA is available).  Yields the
    profile."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    path = os.path.join(str(ensure_dir(log_dir)), "trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """The length of the union of ``(start, end)`` intervals: points that
    several intervals cover count once."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def device_busy(prof: torch.profiler.profile, wall_seconds: float) -> dict:
    """A finished profile's device time (the union of the intervals of its
    device activities: kernels, copies, sets, not the ranges that annotate
    them; operations that overlap, on two streams, count once) beside its
    wall time; None where the trace holds no device time.  Reads the raw
    trace: ``key_averages()`` builds the whole event tree in Python first,
    which takes tens of seconds for a few thousand steps."""
    cuda = torch.autograd.DeviceType.CUDA
    total_ns = union_ns((e.start_ns(), e.start_ns() + e.duration_ns())
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type() == cuda and not e.is_user_annotation())
    if not total_ns:
        return {"device_seconds": None, "wall_seconds": wall_seconds, "busy_share": None}
    return {"device_seconds": total_ns / 1e9, "wall_seconds": wall_seconds,
            "busy_share": total_ns / 1e9 / wall_seconds}
