"""A configuration names its model, and the harness finds the model's
reference, step counts and control by that name alone: today's
configurations resolve to ``models/directgcn.py``, one that names no model
or an unknown one raises and names its file, and a stub model written into
a copy of the folder's layout is found, read by ``mfu`` and run in a cell."""

import copy
import json
import re
import shutil

import pytest
import torch

from perfbench.lib import corpus, manifest, runner
from perfbench.lib.trace import TraceSummary
from perfbench.reference import level as ref_level

BENCH = manifest.benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]
INTERFACE = ("reference_level", "first_steps", "step_shape", "step_flops")
REAL_MODELS = manifest.BENCH_DIR / "models"
# The small mix of test_perfbench_reference.py: its n = 3 level takes the
# hypercube under "auto".
MIX = {"corpus": {"sequences": 200, "min_length": 20, "max_length": 80, "data_seed": 5},
       "n": 3, "feat_dim": 16, "num_classes": 4}

# A second architecture in the stub's place: it hands the harness's calls to
# the DirectGCN module, which it loads by path, and counts its own step.
STUB = '''
import importlib.util
from types import SimpleNamespace

_spec = importlib.util.spec_from_file_location("stub_inner_directgcn", {directgcn!r})
_inner = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_inner)
FLOPS = 123456789


def reference_level(level, cfg, device):
    return _inner.reference_level(level, cfg, device)


def first_steps(level, cfg, x, y, num_classes, seed, steps, device, tf32=False,
                half_batch=False):
    return _inner.first_steps(level, cfg, x, y, num_classes, seed, steps, device, tf32=tf32,
                              half_batch=half_batch or {half_batch})


def step_shape(level, cfg, mix, dtype):
    return SimpleNamespace(dtype=dtype)


def step_flops(shape):
    return FLOPS
'''


@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_resolves_to_directgcn(name):
    assert manifest.config(BENCH, name)["model"] == "directgcn"
    model = manifest.model(BENCH, name)
    assert model.__file__ == str(REAL_MODELS / "directgcn.py")
    assert all(callable(getattr(model, f)) for f in INTERFACE)


@pytest.mark.parametrize("stated", [None, "gat_not_written_yet", "../lib/runner"],
                         ids=["none", "unknown", "a_path"])
def test_configuration_without_a_model_module_raises_naming_its_file(stated, tmp_path):
    bench = copy.deepcopy(BENCH)
    entry = bench["configs"][0]
    cfg = manifest.config(BENCH, entry["name"])
    del cfg["model"]
    if stated is not None:
        cfg["model"] = stated
    entry["file"] = str(tmp_path / "config.json")
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=re.escape(entry["file"])):
        manifest.model(bench, entry["name"])


def _layout(tmp_path, monkeypatch, half_batch=False):
    """A copy of the folder's layout with a stub model and a cell of it, the
    harness pointed at it; returns the benchmark and the cell."""
    root = tmp_path / "bench"
    for sub in ("metrics", "limits"):
        shutil.copytree(manifest.BENCH_DIR / sub, root / sub)
    (root / "models").mkdir()
    (root / "models" / "stub.py").write_text(
        STUB.format(directgcn=str(REAL_MODELS / "directgcn.py"), half_batch=half_batch))
    shutil.copy(root / "limits" / "hyper.ngram4.json", root / "limits" / "stub.ngram4.json")
    cfg = manifest.config(BENCH, "directgcn-hyper")
    cfg["model"] = "stub"
    (root / "configs").mkdir()
    (root / "configs" / "stub.json").write_text(json.dumps(cfg))
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "stub", "source": "a stub", "reduced": [], "why": "a stub",
                             "file": str(root / "configs" / "stub.json")})
    cell = {"name": "stub.ngram4", "config": "stub", "traffic": "ngram4", "chips": 1,
            "why": "a stub"}
    bench["workloads"].append(cell)
    monkeypatch.setattr(manifest, "BENCH_DIR", root)
    return bench, cell


def test_stub_model_is_found_by_name_alone(tmp_path, monkeypatch):
    bench, _ = _layout(tmp_path, monkeypatch)
    model = manifest.model(bench, "stub")
    assert model.__file__ == str(tmp_path / "bench" / "models" / "stub.py")
    assert all(callable(getattr(model, f)) for f in INTERFACE)
    assert model.step_flops(None) == model.FLOPS


def test_mfu_reads_the_stub_step_flops_over_the_step(tmp_path, monkeypatch):
    bench, _ = _layout(tmp_path, monkeypatch)
    model = manifest.model(bench, "stub")
    mfu = manifest.metric_reader("mfu")
    trace = TraceSummary(window_s=2.0, busy_s=1.5, epochs=4, device_ops=[], gaps=[])
    ctx = runner.RunContext(model=model, shape=model.step_shape(None, {}, MIX, "float32"),
                            device_kind="NVIDIA H100 80GB HBM3", level_start_s=1.0,
                            peak_bytes=None, trace=trace)
    assert mfu.read(ctx) == 100.0 * model.FLOPS / (0.5 * 67e12)


def test_directgcn_first_steps_equal_the_reference_level_to_the_bit(tmp_path):
    fasta, _ = corpus.level_files(MIX, tmp_path)
    cfg = manifest.config(BENCH, "directgcn-hyper")
    model = manifest.model(BENCH, "directgcn-hyper")
    device = torch.device("cpu")
    level = runner.reference_level(model, cfg, MIX, fasta, device)
    x, y = corpus.draw_inputs(level.num_nodes, MIX["feat_dim"], MIX["num_classes"], 2**33 + 7)
    ours = model.first_steps(level, cfg, x, y, MIX["num_classes"], 2**33 + 7, 3, device)
    old = ref_level.build_level(str(fasta), MIX["n"], cfg["node_space"],
                                cfg["propagation_epsilon"], device)
    theirs = ref_level.first_steps(old, cfg, x, y, MIX["num_classes"], 2**33 + 7, 3, device)
    assert level.nnz == old.nnz
    assert ours == theirs
    assert model.step_shape(level, cfg, MIX, "float32").nnz == old.nnz


@pytest.mark.parametrize("half_batch", [False, True], ids=["sound", "wrong_reference"])
def test_run_takes_the_reference_of_the_model_its_configuration_names(half_batch, tmp_path,
                                                                      monkeypatch):
    """A whole run of the stub's cell calls the stub, and a stub whose
    reference is another model's (half the batch) reads not correct."""
    bench, cell = _layout(tmp_path, monkeypatch, half_batch=half_batch)
    cache = tmp_path / "cache"
    r = runner.run_cell(bench, cell, 2**33 + 5, 0.2, False, torch.device("cpu"),
                        cache_root=cache, mix=MIX)
    assert r["correct"] is (not half_batch), r["compared"]
