"""Driving the program's own epoch loop: the clock that opens and closes the
measured window, and the recorder of the first steps that the reference
follows.

``HierarchicalTrainer.train_level`` calls ``metrics.log_metrics(values,
step=epoch)`` once an epoch, after the epoch's loss has been read back (a read
that waits for the card).  ``EpochClock`` is that ``metrics`` object: it
keeps the losses of the checked steps, opens the window at the end of the
last warm-up epoch and ends the level by raising ``WindowClosed`` once the
window has lasted its seconds, so the eval pass after the loop is never
reached.  ``StepRecorder`` reads the optimizer through torch's global
optimizer-step hooks: the parameters before the first step, the first
gradient from the first moment after it, and each leaf's change after the
last checked step.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from perfbench.lib import trace as trace_lib


class WindowClosed(BaseException):
    """Ends the level from inside its loop.  A BaseException, so that no
    handler of the program's for errors takes it."""


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EpochClock:
    def __init__(self, device: torch.device, warmup_epochs: int, seconds: float,
                 checked_steps: int, trace_seconds: Optional[float] = None,
                 trace_warmup_epochs: int = 2, recorder: Optional["StepRecorder"] = None):
        self.device = device
        self.recorder = recorder
        # Optimizer steps taken by the end of each checked epoch.
        self.steps_at_checked: List[int] = []
        self.warmup = warmup_epochs
        self.seconds = seconds
        self.checked = checked_steps
        self.losses: List[float] = []
        self.window_losses: List[float] = []
        self.first_epoch_end: Optional[float] = None
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.epochs = 0
        # Traced runs: the device-only profile spans ``trace_seconds`` after
        # ``trace_warmup_epochs``; ``name_epochs`` more name the idle gaps.
        self.trace_seconds = trace_seconds
        self.trace_warmup = trace_warmup_epochs
        self.name_epochs = 5
        self.prof = None
        self.gap_prof = None
        self._trace_open_epoch: Optional[int] = None
        self._gap_open_epoch = 0
        self._trace_t0 = 0.0
        self.traced_window_s = 0.0
        self.traced_epochs = 0

    def log_metrics(self, values: dict, step: int) -> None:
        now = time.perf_counter()
        if step == 1:
            self.first_epoch_end = now
        if step <= self.checked:
            self.losses.append(float(values["loss"]))
            if self.recorder is not None:
                self.steps_at_checked.append(self.recorder.calls)
        if step < self.warmup:
            return
        if step == self.warmup:
            _sync(self.device)
            self.t_open = time.perf_counter()
            return
        self.window_losses.append(float(values["loss"]))
        if self.trace_seconds is not None:
            self._trace_epoch(step)
        elif now - self.t_open >= self.seconds:
            self._close(step)

    def _close(self, step: int) -> None:
        _sync(self.device)
        self.t_close = time.perf_counter()
        self.epochs = step - self.warmup
        raise WindowClosed()

    # -- traced runs --------------------------------------------------------

    def _start_profiler(self, host: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if host or self.device.type != "cuda" else []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        _sync(self.device)
        return prof

    def _mark(self, name: str) -> None:
        _sync(self.device)
        with torch.profiler.record_function(name):
            pass

    def _trace_epoch(self, step: int) -> None:
        """Traced runs: ``trace_warmup`` epochs, the device-only window of
        ``trace_seconds``, then ``name_epochs`` epochs traced with host
        activity to name the idle gaps; then the level ends."""
        since = step - self.warmup
        if since == self.trace_warmup:
            self.prof = self._start_profiler(host=False)
            self._trace_open_epoch = step
            self._trace_t0 = time.perf_counter()
        elif self._trace_open_epoch is not None and self.gap_prof is None:
            if time.perf_counter() - self._trace_t0 >= self.trace_seconds:
                _sync(self.device)
                self.traced_window_s = time.perf_counter() - self._trace_t0
                self.traced_epochs = step - self._trace_open_epoch
                self.prof.stop()
                self.gap_prof = self._start_profiler(host=True)
                self._mark(trace_lib.OPEN_MARK)
                self._gap_open_epoch = step
        elif self.gap_prof is not None and step - self._gap_open_epoch >= self.name_epochs:
            self._mark(trace_lib.CLOSE_MARK)
            self.gap_prof.stop()
            self._close(step)


class StepRecorder:
    """Readings of the program's first ``steps`` optimizer steps, taken
    through ``torch.optim.optimizer``'s global step hooks: ``p0`` before the
    first, ``grad_norms`` (float64, from the first moment) after it, and
    ``change_norms`` after the last.  ``calls`` counts every step taken."""

    def __init__(self, steps: int, adam_b1: float):
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)

        self.steps = steps
        self.b1 = adam_b1
        self.calls = 0
        self.numels: Optional[List[int]] = None
        self.grad_norms: Optional[List[Optional[float]]] = None
        self.change_norms: Optional[List[float]] = None
        self._p0: Optional[List[torch.Tensor]] = None
        self._handles = [register_optimizer_step_pre_hook(self._pre),
                         register_optimizer_step_post_hook(self._post)]

    @staticmethod
    def _params(opt) -> List[torch.Tensor]:
        return [p for group in opt.param_groups for p in group["params"]]

    def _pre(self, opt, args, kwargs) -> None:
        self.calls += 1
        if self.calls == 1:
            ps = self._params(opt)
            self.numels = [p.numel() for p in ps]
            self._p0 = [p.detach().clone() for p in ps]

    def _post(self, opt, args, kwargs) -> None:
        ps = self._params(opt)
        if self.calls == 1:
            self.grad_norms = [self._first_grad_norm(opt.state.get(p, {})) for p in ps]
        if self.calls == self.steps:
            self.change_norms = [float(torch.linalg.vector_norm((p.detach() - p0).double()))
                                 for p, p0 in zip(ps, self._p0)]
            self._p0 = None
            self.remove()

    def _first_grad_norm(self, state: dict) -> Optional[float]:
        """The first gradient's norm from Adam's first moment after one step,
        ``(1 - b1) * g``; None where the state holds no first moment."""
        mu = next((state[k] for k in ("mu", "exp_avg") if k in state), None)
        if mu is None:
            return None
        return float(torch.linalg.vector_norm(mu.double())) / (1.0 - self.b1)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
