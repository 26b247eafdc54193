"""Finding a cell's pieces by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<mix>.json``), its limits
(``limits/<cell>.json``) and the readers of its per-layer metrics
(``metrics/<metric>.py``).  A later cell, mix, configuration or metric is a
new file and a new entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


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


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


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
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
