"""Finding a cell's pieces by name: the cell in ``BENCHMARK.json``, its
configuration file, the model that file names (``models/<model>.py``), its
traffic mix (``traffic/<mix>.json``), its limits (``limits/<cell>.json``) and
the readers of its per-layer metrics (``metrics/<metric>.py``).  A later
cell, mix, configuration, model or metric is a new file and a new entry;
nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
_MODEL_NAME = re.compile(r"^[A-Za-z0-9_]{1,64}$")


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    return _json(ROOT / _config_entry(bench, name)["file"])


def model(bench: dict, name: str) -> ModuleType:
    """The module of the model that configuration ``name`` states under
    ``model``: ``models/<model>.py``, with ``reference_level``,
    ``first_steps``, ``step_shape`` and ``step_flops`` (see README.md).
    Raises, naming the configuration's file, where it states none or one
    that has no module."""
    file = _config_entry(bench, name)["file"]
    stated = _json(ROOT / file).get("model")
    if not isinstance(stated, str) or not _MODEL_NAME.match(stated):
        raise ValueError(f"{file} states no model by name (its \"model\" key: {stated!r}); "
                         "it names the module models/<model>.py")
    path = BENCH_DIR / "models" / f"{stated}.py"
    if not path.is_file():
        raise ValueError(f"{file} states model {stated!r}, and there is no {path}")
    return _load("perfbench_model_" + stated, path)


def traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell: str) -> dict:
    return _json(BENCH_DIR / "limits" / f"{cell}.json")


def end_to_end(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The cell's per-layer metrics: those whose ``workloads`` list it.
    Every per-layer entry names its cells."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def metric_reader(name: str) -> ModuleType:
    return _load("perfbench_metric_" + name.replace(".", "_"),
                 BENCH_DIR / "metrics" / f"{name}.py")


def _load(module_name: str, path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
