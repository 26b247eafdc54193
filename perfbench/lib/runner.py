"""One run of one cell: set-up, the measured window through the program's own
epoch loop, the reference's check of the first steps, and the result line.

Set-up is the process start, the level's graph (built on a cell's first run
in a checkout, loaded after), the seeded inputs, and ``train_level``'s plan,
operator build, parameter initialisation and ``WARMUP_EPOCHS`` epochs, the
first ``CHECKED_STEPS`` of which the reference follows.  The window then
runs the trainer's epochs until it has lasted ``--seconds`` (untraced), or,
traced, starts the profiler, lets ``TRACE_WARMUP_EPOCHS`` pass and traces
``TRACE_SECONDS``.  The level ends inside its loop, before its eval pass.
After the window the peak is read, the program's state freed, and the
reference of the model that the configuration names (``models/<model>.py``,
found by ``manifest.model``) run on the card.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import List, Optional

import torch

from perfbench.lib import check, corpus, manifest
from perfbench.lib import trace as trace_lib
from perfbench.lib.window import EpochClock, StepRecorder, WindowClosed
from perfbench.reference import level as ref_level

WARMUP_EPOCHS = 5
CHECKED_STEPS = 3
TRACE_SECONDS = 2.0
TRACE_WARMUP_EPOCHS = 2
ADAM_B1 = 0.9
# Top-level module names that no module of a run may have.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "protgram_directgcn_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, 10 ms resolution)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES)


@dataclasses.dataclass
class ProgramRun:
    clock: EpochClock
    recorder: StepRecorder
    t_call: float
    peak_bytes: Optional[int]
    trace: Optional[trace_lib.TraceSummary]
    plan: object  # the trainer's LevelPlan for the level


def run_program(cfg: dict, graph, x, y, num_classes: int, seed: int, seconds: float,
                traced: bool, device: torch.device) -> ProgramRun:
    """The level through ``HierarchicalTrainer.train_level`` until the window
    closes.  The plan that ``train_level`` takes is kept as the trainer made
    it (its ``_level_plan`` wrapped on this one instance)."""
    from protgram_directgcn_torch.config import Config
    from protgram_directgcn_torch.pipeline.trainer import HierarchicalTrainer

    config = Config()
    config.random_state = int(seed)
    config.apply_overrides({f"gcn.{k}": v for k, v in cfg["gcn"].items()})
    trainer = HierarchicalTrainer(config, device=device)
    plans = []
    level_plan = trainer._level_plan

    def recorded_plan(*args, **kwargs):
        plans.append(level_plan(*args, **kwargs))
        return plans[-1]

    trainer._level_plan = recorded_plan
    recorder = StepRecorder(CHECKED_STEPS, ADAM_B1)
    clock = EpochClock(device, WARMUP_EPOCHS, seconds, CHECKED_STEPS,
                       trace_seconds=TRACE_SECONDS if traced else None,
                       trace_warmup_epochs=TRACE_WARMUP_EPOCHS, recorder=recorder)
    t_call = time.perf_counter()
    try:
        trainer.train_level(graph, x, y, num_classes, ckpt_dir=None, metrics=clock)
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the level ended before the window closed")
    finally:
        recorder.remove()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    summary = None
    if clock.prof is not None:
        summary = trace_lib.device_window(clock.prof, clock.traced_window_s,
                                          clock.traced_epochs)
        if summary is not None and clock.gap_prof is not None:
            summary.gaps = trace_lib.named_gaps(clock.gap_prof)
        clock.prof = clock.gap_prof = None
    return ProgramRun(clock, recorder, t_call, peak, summary, plans[-1])


def check_plan(plan, cfg: dict) -> None:
    """Raises where the level ran otherwise than the configuration states:
    in another compute type than its ``precision``, or at hidden widths that
    the oversize policy cut."""
    if plan.compute_dtype != cfg["precision"]:
        raise ValueError(f"the plan computes in {plan.compute_dtype}, the configuration "
                         f"states precision {cfg['precision']}")
    if plan.layer_dims_override is not None:
        raise ValueError(f"the plan cut the hidden widths to {plan.layer_dims_override}")


def reference_level(model: ModuleType, cfg: dict, mix: dict, fasta: Path, device):
    """The model's reference level: the graph re-derived from the FASTA on
    the configuration's node space, and the model's operators on it."""
    level = ref_level.graph_level(str(fasta), mix["n"], cfg["node_space"], device)
    return model.reference_level(level, cfg, device)


@dataclasses.dataclass
class RunContext:
    """What a per-layer reader reads.  ``shape`` is the model's
    ``step_shape``, whose ``dtype`` is the plan's compute type."""

    model: ModuleType
    shape: object
    device_kind: str
    level_start_s: float
    peak_bytes: Optional[int]
    trace: Optional[trace_lib.TraceSummary]


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, traced: bool,
             device: torch.device, cache_root: Path = corpus.CACHE,
             mix: Optional[dict] = None) -> dict:
    """One run; returns the result line's object.  ``mix`` stands in for
    the cell's traffic file (the folder's tests run small mixes).  Raises,
    so that no result is printed, where the level ran otherwise than the
    configuration states (``check_plan``)."""
    age0, t0 = process_age_s(), time.perf_counter()
    cfg = manifest.config(bench, cell["config"])
    model = manifest.model(bench, cell["config"])
    mix = mix or manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell["name"])
    fasta, graph_path = corpus.level_files(mix, cache_root)

    from protgram_directgcn_torch.graph.structure import load_graph

    graph = load_graph(graph_path)
    if graph.epsilon_propagation != cfg["propagation_epsilon"]:
        raise ValueError(f"the level's graph has epsilon {graph.epsilon_propagation}, the "
                         f"configuration {cfg['propagation_epsilon']}")
    x, y = corpus.draw_inputs(graph.num_nodes, mix["feat_dim"], mix["num_classes"], seed)
    t_inputs = time.perf_counter()
    run = run_program(cfg, graph, x, y, mix["num_classes"], seed, seconds, traced, device)
    del graph
    check_plan(run.plan, cfg)
    clock = run.clock
    setup_s = age0 + (clock.t_open - t0)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    level = reference_level(model, cfg, mix, fasta, device)
    ref = model.first_steps(level, cfg, x, y, mix["num_classes"], seed, CHECKED_STEPS, device)
    t_done = time.perf_counter()
    prog = {"losses": clock.losses, "grad_norms": run.recorder.grad_norms,
            "change_norms": run.recorder.change_norms, "numels": run.recorder.numels,
            "steps_at_checked": clock.steps_at_checked}
    numbers, notes = check.compare(prog, ref)
    failed = sum(1 for v in clock.window_losses if not math.isfinite(v))
    correct = (failed == 0 and all(numbers[k] <= limits[k]["limit"] for k in check.NUMBERS))

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    ctx = RunContext(model=model,
                     shape=model.step_shape(level, cfg, mix, run.plan.compute_dtype),
                     device_kind=kind, level_start_s=clock.first_epoch_end - run.t_call,
                     peak_bytes=run.peak_bytes, trace=run.trace)
    if traced:
        metrics = {}
        for m in manifest.per_layer(bench, cell["name"]):
            value = manifest.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"step_ms": 1e3 * (clock.t_close - clock.t_open) / clock.epochs,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(bench, cell["name"])
                   if values.get(m["name"]) is not None}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": clock.epochs, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
        result["traced_steps"] = run.trace.epochs
    result["notes"] = notes
    # Where a run's time went (host clock): to the level's call (imports,
    # graph, inputs), the level to its window, the window, the reference.
    result["seconds"] = {"before_level": age0 + (t_inputs - t0),
                         "level_to_window": clock.t_open - t_inputs,
                         "window": clock.t_close - clock.t_open,
                         "reference": t_done - t_ref}
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]["limit"]}
                          for k in check.NUMBERS}
    return result


def main(workload: str, seed: int, seconds: float, traced: bool) -> int:
    bench = manifest.benchmark()
    cell = manifest.workload(bench, workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, seed, seconds, traced, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"perfbench: modules loaded that a run may not load: {found}", file=sys.stderr)
        return 3
    for note in result["notes"]:
        print(f"perfbench: {note}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_finite(result), allow_nan=False))
    return 0


def _finite(obj):
    """The result with every non-finite number as null (JSON has none)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj
