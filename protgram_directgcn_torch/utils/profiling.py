"""Profiling and performance instrumentation.

Port of protgram_directgcn_tpu/utils/profiling.py onto ``torch.profiler``:

- ``trace(name)``: a ``record_function`` range (it shows in a profiler
  trace) and wall timing in one context manager;
- ``capture_trace(dir)``: ``torch.profiler`` over the CPU and, where CUDA
  is present, the card's kernels, written as a Chrome trace;
- ``StepTimer``: per-step times with the first ``warmup`` discarded;
- ``spmm_roofline_edges_per_s`` and ``detect_bandwidth`` (memory rate of
  the device, by name);
- ``profiler`` and ``device_busy``: a profile of the device's activity,
  and its device time beside its wall time (the device's busy share).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Union

import torch

from protgram_directgcn_torch.utils.io import ensure_dir, logger

# Memory rate (bytes/s) by device: the CPU entry of the JAX package, and the
# H100 SXM 80 GB HBM3's spec rate, keyed by ``torch.cuda.get_device_name``.
MEMORY_BANDWIDTH = {
    "cpu": 5.0e10,
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


@contextlib.contextmanager
def trace(name: str, log: bool = False):
    """Mark a region for the profiler and measure its wall time."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if log:
        logger.info("[trace] %s: %.3fs", name, time.perf_counter() - t0)


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


def device_busy(prof: torch.profiler.profile, wall_seconds: float) -> dict:
    """A finished profile's device time (the summed durations of its device
    activities: kernels, copies, sets; not the ranges that annotate them)
    beside its wall time; None where the trace holds no device time.  Reads
    the raw trace: ``key_averages()`` builds the whole event tree in Python
    first, which takes tens of seconds for a few thousand steps."""
    cuda = torch.autograd.DeviceType.CUDA
    total_ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and not e.is_user_annotation())
    if not total_ns:
        return {"device_seconds": None, "wall_seconds": wall_seconds, "busy_share": None}
    return {"device_seconds": total_ns / 1e9, "wall_seconds": wall_seconds,
            "busy_share": total_ns / 1e9 / wall_seconds}


@dataclass
class StepTimer:
    """Collects per-step wall times; reports mean/min after warmup.  A step
    that launches work on the card and does not wait for it is timed on
    the host's clock: synchronize inside the step to time the device."""

    warmup: int = 2
    times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    @property
    def steady(self) -> List[float]:
        return self.times[self.warmup:] if len(self.times) > self.warmup else self.times

    def mean(self) -> float:
        s = self.steady
        return sum(s) / len(s) if s else float("nan")

    def best(self) -> float:
        s = self.steady
        return min(s) if s else float("nan")


def spmm_roofline_edges_per_s(feat_dim: int, bandwidth: float, dtype_bytes: int = 4) -> float:
    """Memory-bound edges/s for gather-style SpMM: one feature row per edge."""
    return bandwidth / (dtype_bytes * feat_dim)


def detect_bandwidth(device: Union[str, torch.device] = "cuda") -> float:
    """The memory rate of ``device``: the CPU's estimate, or the card's by
    its name; a card not in ``MEMORY_BANDWIDTH`` raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return MEMORY_BANDWIDTH["cpu"]
    name = torch.cuda.get_device_name(dev)
    if name not in MEMORY_BANDWIDTH:
        raise ValueError(f"no memory bandwidth known for device {name!r}")
    return MEMORY_BANDWIDTH[name]
