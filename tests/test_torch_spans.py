"""The port's spans (``utils/profiling.trace``) and where the trainer and the
kernel wrappers open them.

Without a profiler a per-step or kernel span is one shared no-op and records
nothing; under one it opens a ``record_function`` range and stores its name,
parent and times.  ``train_level`` records its set-up spans always and
writes ``level_stats[n]`` as the level goes, so a ``metrics`` object that
ends the level inside its loop, as the benchmark's does, finds the plan,
the route and the set-up spans there.  Recording changes no number: a
level's losses are bit-equal with a profiler on and off.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
from protgram_directgcn_torch.ops import ell_kernels
from protgram_directgcn_torch.pipeline import trainer as t_trainer
from protgram_directgcn_torch.utils import profiling

SEQS = [
    ("P1", "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"),
    ("P2", "MKLVTAYIAKQRRQISFVK"),
    ("P3", "GLIEVQAPILSRVGDGTQDNLSGAEKAVQ"),
]
STEP_CHILDREN = ["step.optimizer", "step.forward", "step.backward", "step.optimizer"]


@pytest.fixture(scope="module")
def graphs():
    return NgramGraphBuilder(n_max=3).build_from_sequences(SEQS)


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _names(store=None):
    return [s.name for s in (profiling.spans() if store is None else store)]


def _children(index):
    return [s.name for s in profiling.spans() if s.parent == index]


class _EndsTheLevel(BaseException):
    pass


class _Metrics:
    """Ends the level from ``log_metrics`` at epoch ``stop``, as the
    benchmark's window does; reads ``level_stats`` there."""

    def __init__(self, trainer, n, stop):
        self.trainer, self.n, self.stop = trainer, n, stop
        self.seen = None

    def log_metrics(self, values, step):
        if step == self.stop:
            self.seen = dict(self.trainer.level_stats[self.n])
            raise _EndsTheLevel()


def _trainer(epochs=3, **gcn):
    cfg = Config()
    cfg.apply_overrides({"gcn.hidden_layer_dims": [8, 6], "gcn.epochs_per_level": epochs,
                         "gcn.use_early_stopping": False,
                         **{f"gcn.{k}": v for k, v in gcn.items()}})
    return t_trainer.HierarchicalTrainer(cfg, device="cpu")


def _inputs(graph, feat=6, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(graph.num_nodes, feat)).astype(np.float32)
    y = rng.integers(0, classes, graph.num_nodes).astype(np.int64)
    return x, y, classes


# -----------------------------------------------------------------------------
# The primitive
# -----------------------------------------------------------------------------


def test_span_without_a_profiler_is_the_shared_noop():
    spans = [profiling.trace(name) for name in ("step", "epoch", "ops.k1", "ops.ell_hbm")]
    assert all(s is spans[0] for s in spans)
    for s in spans:
        with s:
            pass
    assert profiling.spans() == []


def test_always_span_records_without_a_profiler():
    with profiling.trace("level.plan", always=True):
        with profiling.trace("step"):  # per-step: not recorded
            pass
    (span,) = profiling.spans()
    assert span.name == "level.plan" and span.parent == -1 and 0 <= span.start_ns <= span.end_ns


def test_spans_under_a_profiler_nest_in_order_and_name_the_trace(tmp_path):
    with profiling.capture_trace(tmp_path / "prof", device="cpu"):
        with profiling.trace("epoch"):
            with profiling.trace("step"):
                torch.ones(8).sum()
            with profiling.trace("epoch.loss_read"):
                pass
    store = profiling.spans()
    assert [(s.name, s.parent) for s in store] == [("epoch", -1), ("step", 0),
                                                   ("epoch.loss_read", 0)]
    assert store[0].start_ns <= store[1].start_ns <= store[1].end_ns <= store[2].start_ns
    assert store[2].end_ns <= store[0].end_ns
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"epoch", "step", "epoch.loss_read"} <= names


def test_self_time_excludes_the_children():
    with profiling.trace("outer", always=True):
        with profiling.trace("inner", always=True):
            time.sleep(0.02)
        with profiling.trace("inner", always=True):
            time.sleep(0.01)
    outer, a, b = profiling.spans()
    own = profiling.self_ns()
    durations = [s.end_ns - s.start_ns for s in (outer, a, b)]
    assert own[0] == durations[0] - durations[1] - durations[2]
    assert own[0] < 0.01e9 and own[1] >= 0.02e9
    assert profiling.span_seconds(["inner"]) == {"inner": a.seconds + b.seconds}


def test_span_closes_on_an_exception_and_a_reset_inside_is_kept():
    with pytest.raises(_EndsTheLevel):
        with profiling.trace("level.first_epoch", always=True):
            raise _EndsTheLevel()
    assert profiling.spans()[0].end_ns >= profiling.spans()[0].start_ns
    with profiling.trace("before", always=True):
        profiling.reset_spans()
        with profiling.trace("after", always=True):
            pass
    assert [(s.name, s.parent) for s in profiling.spans()] == [("after", -1)]


def test_trace_outside_closes_the_open_ranges_for_its_call():
    with _cpu_profile():
        with profiling.trace("epoch") as epoch:
            with profiling.trace_outside("epoch.log"):
                assert epoch.range is None
            assert epoch.range is not None
    assert [(s.name, s.parent) for s in profiling.spans()] == [("epoch", -1), ("epoch.log", 0)]
    assert profiling.trace_outside("epoch.log") is profiling.trace("step")  # nothing open


class _SwitchesProfilers:
    """Stops the running profiler and starts another inside ``log_metrics``,
    as the benchmark's traced window does."""

    def __init__(self, first):
        self.prof = first

    def log_metrics(self, values, step):
        if step == 2:
            self.prof.stop()
            self.prof = _cpu_profile()
            self.prof.start()


def test_a_callback_that_switches_profilers_inside_the_epoch_is_safe(graphs):
    """The ranges open around ``log_metrics`` (``epoch``) close before it and
    open again after it: closed under another profiler than the one they
    opened under, they would corrupt its memory."""
    tt = _trainer(epochs=4, spmm_mode="dense", use_cluster_training=False)
    first = _cpu_profile()
    first.start()
    metrics = _SwitchesProfilers(first)
    try:
        tt.train_level(graphs[1], *_inputs(graphs[1]), metrics=metrics)
    finally:
        metrics.prof.stop()
    import gc

    gc.collect()
    names = [e.name() for e in metrics.prof.profiler.kineto_results.events()]
    assert names.count("step") == 2 and "epoch" in names
    assert _names().count("epoch") == 4 and _names().count("epoch.log") == 4


def test_ell_wrapper_span_on_the_cpu_path():
    idx = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    w = torch.ones((2, 2), dtype=torch.float32)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ell_kernels.ell_hbm(idx, w, x)
    assert profiling.spans() == []
    with _cpu_profile():
        out = ell_kernels.ell_hbm(idx, w, x)
        ell_kernels.ell_resident(idx, w, x, "bwd")
    torch.testing.assert_close(out, ell_kernels.ell_plain(idx, w, x))
    assert _names() == ["ops.ell_hbm", "ops.ell_resident"]


# -----------------------------------------------------------------------------
# train_level
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("mode,level", [("pallas", 3), ("hypercube", 2), ("dense", 2)])
def test_setup_spans_and_level_stats_when_the_level_ends_inside_its_loop(graphs, mode, level):
    graph = graphs[level - 1]
    tt = _trainer(epochs=10, spmm_mode=mode, use_cluster_training=False)
    metrics = _Metrics(tt, level, stop=3)
    with pytest.raises(_EndsTheLevel):
        tt.train_level(graph, *_inputs(graph), metrics=metrics)
    st = metrics.seen
    assert st["route"] == {"pallas": "ell"}.get(mode, mode)
    assert st["plan"]["compute_dtype"] == "float32" and st["operator_seconds"] > 0
    assert {"level.plan", "level.operators", "operators.transforms", "operators.build",
            "level.init", "level.first_epoch"} <= set(st["spans"])
    assert "level.eval" not in st["spans"]
    assert st["spans"]["operators.build"] <= st["spans"]["level.operators"]
    # Untraced: the store holds the always-on set-up spans alone.
    assert set(_names()) <= set(t_trainer.SETUP_SPANS)
    assert _names().count("level.first_epoch") == 1


def test_whole_untraced_level_keeps_its_stats_and_setup_spans_only(graphs):
    tt = _trainer(spmm_mode="dense", use_cluster_training=False)
    tt.train_level(graphs[1], *_inputs(graphs[1]))
    st = tt.level_stats[2]
    assert {"route", "staged", "layer_dims", "plan", "nodes", "device_nodes", "epochs",
            "losses", "operator_seconds", "train_seconds", "eval_seconds", "launches",
            "eval_launches", "peak_device_bytes", "start_epoch", "steps", "spans"} <= set(st)
    assert set(_names()) <= set(t_trainer.SETUP_SPANS) and "level.eval" in st["spans"]
    assert st["spans"]["level.operators"] == pytest.approx(st["operator_seconds"], abs=0.05)


def _traced_level(tt, graph, **kw):
    with _cpu_profile():
        tt.train_level(graph, *_inputs(graph), **kw)
    return profiling.spans()


def test_fused_epoch_spans_under_a_profiler(graphs):
    tt = _trainer(spmm_mode="dense", use_cluster_training=False)
    store = _traced_level(tt, graphs[1], metrics=_Metrics(tt, 2, stop=None))
    epochs = [i for i, s in enumerate(store) if s.name == "epoch"]
    assert len(epochs) == 3
    assert store[epochs[0]].parent == _names().index("level.first_epoch")
    for i in epochs:
        assert _children(i) == ["step", "epoch.loss_read", "epoch.log", "epoch.end"]
        step = next(j for j in range(i, len(store)) if store[j].name == "step")
        assert _children(step) == STEP_CHILDREN
    assert _names().count("level.eval") == 1


def test_staged_epoch_spans_under_a_profiler(graphs):
    tt = _trainer(spmm_mode="hypercube", use_cluster_training=False)
    plan = tt._level_plan
    tt._level_plan = lambda *a, **k: dataclasses.replace(plan(*a, **k), stage_split=1)
    store = _traced_level(tt, graphs[1])
    assert tt.level_stats[2]["staged"]
    steps = [i for i, s in enumerate(store) if s.name == "step"]
    assert len(steps) == 3
    # zero_grad, the forward, the decoder's backward and update, then a
    # backward stage and an update a layer, from the last layer down.
    expected = ["step.optimizer", "step.forward"] + ["step.backward", "step.optimizer"] * 3
    for i in steps:
        assert _children(i) == expected


def test_cluster_epoch_spans_under_a_profiler(graphs):
    graph = graphs[2]
    tt = _trainer(epochs=2, spmm_mode="auto", cluster_training_threshold_nodes=10,
                  target_nodes_per_cluster=10, cluster_device_budget_bytes=0)
    _traced_level(tt, graph)
    st = tt.level_stats[3]
    assert st["route"] == "cluster" and not st["resident"]
    assert "level.cluster_batches" in st["spans"]
    names = _names()
    assert names.count("epoch") == 2 and names.count("epoch.loss_read") == 2
    assert names.count("step") == names.count("batch.to_device") == st["steps"]
    for i, s in enumerate(profiling.spans()):
        if s.name == "epoch":
            kids = _children(i)
            assert kids[-2:] == ["epoch.loss_read", "epoch.end"]
            assert kids[:-2] == ["batch.to_device", "step"] * st["clusters"]


@pytest.mark.parametrize("staged", [False, True])
def test_losses_are_bit_equal_with_a_profiler_on_and_off(graphs, staged):
    runs = []
    for traced in (False, True):
        tt = _trainer(spmm_mode="hypercube", use_cluster_training=False)
        if staged:
            plan = tt._level_plan
            tt._level_plan = lambda *a, _p=plan, **k: dataclasses.replace(_p(*a, **k),
                                                                          stage_split=1)
        if traced:
            _traced_level(tt, graphs[1])
        else:
            tt.train_level(graphs[1], *_inputs(graphs[1]))
        runs.append(tt.level_stats[2]["losses"])
    assert runs[0] == runs[1]
