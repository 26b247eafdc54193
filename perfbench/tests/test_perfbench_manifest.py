"""``BENCHMARK.json`` against the forms its fields must keep, and every name in it
finding its file: configurations, traffic mixes, limits and per-layer
metric readers."""

import json
import re

import pytest

from perfbench.lib import check, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = manifest.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for entry in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(cell):
    w = manifest.workload(BENCH, cell)
    cfg = manifest.config(BENCH, w["config"])
    mix = manifest.traffic(w["traffic"])
    limits = manifest.limits(cell)
    assert set(limits) >= set(check.NUMBERS)
    assert {"gcn", "node_space", "propagation_epsilon", "decoder_dropout"} <= set(cfg)
    assert {"corpus", "n", "feat_dim", "num_classes"} <= set(mix)
    reported = {m["name"] for m in manifest.end_to_end(BENCH, cell)}
    assert "setup_s" in reported and len(reported) >= 2
    assert manifest.per_layer(BENCH, cell)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_agrees_with_the_manifest(metric):
    reader = manifest.metric_reader(metric["name"])
    assert reader.UNIT == metric["unit"]
    assert reader.LAYER == metric["layer"]
    assert reader.MOVES == metric["moves"]
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert callable(reader.read)
    assert reader.read(_NoTrace()) is None or metric["source"] == "host_clock"


def test_every_per_layer_metric_names_its_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells, m


class _NoTrace:
    trace = None
    peak_bytes = None
    level_start_s = 1.0
