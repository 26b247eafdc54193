"""Port parity: the scaling harness (``protgram_directgcn_torch/bench/scaling.py``).

The synthetic graphs are byte-equal to the JAX package's
(``bench/scaling.py``), and the 5-gram recipe (at 200 sequences) to the
root ``bench.build_or_load_graph``'s, fresh and from its cache (each
package's cache in this test's directory).  On 2 gloo ranks (one spawn,
``tests/torch_dist_worker.py``) every report runs at D = 1 and 2, every
curve of the fixed-graph report on a small saved level: finite points with
the JAX package's fields, efficiency and retention 1.0 at D = 1.
"""

import math
import pickle

import numpy as np
import pytest

import bench as root_bench
from protgram_directgcn_torch.bench import scaling as t_sc
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
from protgram_directgcn_tpu.bench import scaling as j_sc
from tests import torch_dist_worker as W
from tests.test_torch_graph import write_seeded_fasta

FIELDS = ["shards", "num_nodes", "nnz", "seconds_per_step", "edges_per_s", "efficiency",
          "aggregate_retention"]


@pytest.mark.parametrize("name", ["_ngram_pattern_graph", "_uniform_graph"])
def test_synthetic_graphs_equal_jax(name):
    for args in ((256, 16, 0), (1024, 5, 3)):
        for t, j in zip(getattr(t_sc, name)(*args), getattr(j_sc, name)(*args)):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
    assert [f.name for f in t_sc.ScalingPoint.__dataclass_fields__.values()] == FIELDS


def test_fivegram_recipe_equals_the_root_bench(tmp_path, monkeypatch):
    monkeypatch.setattr(root_bench, "_CACHE", str(tmp_path / "jax_cache.npz"))
    cache = str(tmp_path / "torch_cache.npz")
    for attempt in ("fresh", "cached"):
        j = root_bench.build_or_load_graph(200)
        t = t_sc.build_or_load_graph(200, cache=cache)
        for a, b in zip(t[:3], j[:3]):
            assert a.dtype == b.dtype, attempt
            np.testing.assert_array_equal(a, b)
        assert t[3] == j[3] and t[4][2] == j[4][2] and t[5][1] == j[5][1]
        for a, b in ((t[4][0], j[4][0]), (t[4][1], j[4][1]), (t[5][0], j[5][0])):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype, attempt


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    d = tmp_path_factory.mktemp("scaling")
    fasta = write_seeded_fasta(d / "s.fasta", n_seqs=30, lo=10, hi=40)
    level = NgramGraphBuilder(n_max=2).run(fasta, d / "graphs")[1]
    W.spawn(W.scaling_scenarios, 2, str(d), str(level))
    with open(d / "scaling_r0.pkl", "rb") as fh:
        return pickle.load(fh)


def _check(points):
    assert [p["shards"] for p in points] == [1, 2]
    for p in points:
        assert list(p) == FIELDS
        assert all(math.isfinite(p[k]) and p[k] > 0 for k in FIELDS)
    assert points[0]["efficiency"] == points[0]["aggregate_retention"] == 1.0
    assert math.isclose(points[1]["efficiency"], points[1]["aggregate_retention"] / 2)


@pytest.mark.parametrize("report", ["weak", "uniform", "hyper"])
def test_weak_scaling_reports_on_two_ranks(reports, report):
    _check(reports[report])
    if report != "hyper":  # weak scaling: the graph grows with the shards
        assert reports[report][1]["num_nodes"] == 2 * reports[report][0]["num_nodes"]


def test_fixed_graph_report_runs_every_curve(reports):
    out = reports["fivegram"]
    assert list(out) == ["graph", "halo", "tri_halo", "hyper_shard", "hyper_shard_tri", "gspmd"]
    for curve in ("halo", "tri_halo", "hyper_shard", "hyper_shard_tri", "gspmd"):
        _check(out[curve])
        three = curve in ("tri_halo", "hyper_shard_tri")
        assert out[curve][0]["nnz"] == (3 if three else 1) * out["graph"]["nnz"]
