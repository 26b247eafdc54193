"""Port parity: the GNN benchmark (``bench/gnn_benchmarker.py``) against the
JAX package's.

- ``seeded_split`` index-equal;
- the DirectGCN adapter's operators, raw and ``normalized=True``, byte-equal
  to JAX's, formats included, on KarateClub (dense) and a seeded 300-node
  ring (ELL);
- the CSV writer byte-equal to pandas' ``DataFrame(rows).to_csv(index=False)``
  (pandas is imported by this test only): result rows with an ``error`` row,
  list fields, ints with missing cells, floats of every magnitude, quoting;
- ``OptaxAdam(weight_decay=wd)`` within a few ulps of
  ``optax.chain(add_decayed_weights(wd), adam(lr))`` over three steps;
- ``GNNBenchmarker.run`` on KarateClub against JAX's at ``epochs=2``,
  ``n_seeds=1``, ``test_on_undirected=False`` and dropout 0 everywhere (the
  zoo's ``_zoo_configs`` and the DirectGCN decoder's dropout monkeypatched
  in both packages), each model started from the JAX package's parameters
  (the port's init functions monkeypatched to convert them): the result
  rows equal, the summary and full CSVs byte-equal, the history CSVs
  byte-equal but for the losses (float32 sums in other orders: rtol 1e-5),
  the metric log's params equal, and the embeddings files' vectors within
  float16 rounding (rtol 2e-3, atol 2e-3 * max|vector|) of JAX's, the PCA
  scores up to each column's sign (a standardized 2-wide embedding has
  loadings of ±1/√2 that tie, so svd_flip's sign falls to rounding);
- the CLI's ``--stages benchmark --device cpu`` at two epochs.
"""

import dataclasses
import functools
import json
import math

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.__main__ import main as t_main
from protgram_directgcn_torch.bench import datasets as t_data
from protgram_directgcn_torch.bench import gnn_benchmarker as t_bench
from protgram_directgcn_torch.config import Config as TConfig
from protgram_directgcn_torch.models import zoo as t_zoo
from protgram_directgcn_torch.models.mlp import OptaxAdam
from protgram_directgcn_tpu.bench import datasets as j_data
from protgram_directgcn_tpu.bench import gnn_benchmarker as j_bench
from protgram_directgcn_tpu.config import Config as JConfig
from protgram_directgcn_tpu.models import directgcn as j_model
from protgram_directgcn_tpu.models import zoo as j_zoo
from tests.test_torch_zoo import _adj_arrays, _graph_case


@pytest.mark.parametrize("n,seed", [(34, 42), (300, 0), (19_717, 7)])
def test_seeded_split_matches_jax(n, seed):
    ratios = {"train": 0.1, "val": 0.1, "test": 0.8}
    for a, b in zip(t_bench.seeded_split(n, ratios, seed), j_bench.seeded_split(n, ratios, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("graph,fmt", [("karate", "DenseAdj"), ("ring", "EllAdj")])
def test_adapter_operators_match_jax(graph, fmt, normalized):
    jds, tds = _graph_case(graph)
    jg = j_bench._directgcn_device_graph(jds, feat_dim=16, normalized=normalized)
    tg = t_bench._directgcn_device_graph(tds, feat_dim=16, normalized=normalized, device="cpu")
    for key in ("p_in", "p_out", "p_und"):
        ja, ta = getattr(jg, key), getattr(tg, key)
        assert type(ja).__name__ == type(ta).__name__
        if key != "p_und":
            assert type(ta).__name__ == fmt
        jarr, tarr = _adj_arrays(ja), _adj_arrays(ta)
        assert set(jarr) == set(tarr)
        for name in jarr:
            assert tarr[name].astype(jarr[name].dtype).tobytes() == jarr[name].tobytes(), (key,
                                                                                           name)
    assert tg.num_nodes == jg.num_nodes
    assert t_bench.operator_formats(tg) == sorted({type(getattr(tg, k)).__name__[:-3].lower()
                                                   for k in ("p_in", "p_out", "p_und")})


def _rows_cases():
    ok = {"dataset": "KarateClub_Original", "model": "GCN", "best_val_accuracy": 0.5000000149011612,
          "test_accuracy": 0.4642857313156128, "test_accuracy_std": 0.0, "n_seeds": 10,
          "seed_test_accuracies": [0.4643, 0.5, 1.0], "synthetic": False}
    err = {"dataset": "Cora_Original", "model": "GAT", "error": 'CUDA "out" of memory, at x\nline 2',
           "synthetic": True}
    floats = [0.1, 1 / 3, 1e-5, 1.5e-4, 1e16, 1.2345678901234567e-300, 5e-324, 123456789.125, -0.0,
              float("nan"), float("inf"), 2.0, 1e22, 0.30000000000000004]
    return {
        "results_with_error_first": [err, ok, dict(ok, model="GIN")],
        "results_with_error_inside": [ok, err, dict(ok, n_seeds=1, seed_test_accuracies=[])],
        "history": [{"epoch": i, "loss": 0.6931471824645996 / (i + 1), "val_accuracy": 0.5}
                    for i in range(5)],
        "floats": [{"v": v, "i": i} for i, v in enumerate(floats)],
        "ints_and_floats": [{"a": 1, "b": 2.5}, {"a": 3, "b": 4}],
        "bool_missing": [{"s": True}, {"t": "x,y"}, {"s": False, "t": 'q"q'}],
    }


@pytest.mark.parametrize("case", list(_rows_cases()))
def test_csv_writer_byte_equal_to_pandas(tmp_path, case):
    rows = _rows_cases()[case]
    ours, theirs = tmp_path / "ours.csv", tmp_path / "pandas.csv"
    t_bench.write_rows_csv(rows, ours)
    pd.DataFrame(rows).to_csv(theirs, index=False)
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("wd", [0.0, 5e-4, 1e-2])
def test_optax_adam_with_weight_decay_matches_optax_chain(wd):
    """From zero and from random parameters, three steps on the same
    gradients, not reset: within 2 ulps of the largest magnitude a step."""
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(40, 8)).astype(np.float32), "b": np.zeros(8, np.float32)}
    opt = optax.chain(optax.add_decayed_weights(wd), optax.adam(1e-2))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_opt = OptaxAdam(list(tp.values()), lr=1e-2, weight_decay=wd)
    for step in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        upd, state = opt.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(grads[k])
        t_opt.step()
        for k, t in tp.items():
            j = np.asarray(jp[k])
            assert np.abs(t.numpy() - j).max() <= 2 * (step + 1) * np.spacing(np.abs(j).max()), k


# -----------------------------------------------------------------------------
# run() against the JAX package's
# -----------------------------------------------------------------------------


def _no_dropout_configs(bench_cls, zoo):
    def configs(self):
        out = {}
        for name, spec in bench_cls._default_configs(self).items():
            out[name] = dict(spec, params=dict(spec["params"], dropout_rate=0.0))
        return out
    return configs


def _jax_init_of_port_model(model, key):
    """The JAX package's init_params of the same model: the JAX class's
    method reads the dims the port's model keeps under the same names."""
    name = type(model).__name__
    if name == "TongDiGCN":  # zoo.py:424-431 of the JAX package
        k1, k2, k3 = jax.random.split(key, 3)
        return {"fwd": j_zoo.GCN.init_params(model.fwd, k1),
                "bwd": j_zoo.GCN.init_params(model.bwd, k2),
                "w_final": j_zoo._glorot(k3, (2 * model.hidden_dim, model.out_dim)),
                "b_final": jnp.zeros(model.out_dim)}
    return j_zoo.ZOO_MODELS[name].init_params(model, key)


@pytest.fixture(scope="module")
def karate_runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        for mod, zoo in ((j_bench, j_zoo), (t_bench, t_zoo)):
            cls = mod.GNNBenchmarker
            mp.setattr(cls, "_default_configs", cls._zoo_configs, raising=False)
            mp.setattr(cls, "_zoo_configs", _no_dropout_configs(cls, zoo))
            mp.setattr(mod, "DirectGCNConfig", functools.partial(mod.DirectGCNConfig,
                                                                 decoder_dropout=0.0))
        j_fields = {f.name for f in dataclasses.fields(j_model.DirectGCNConfig)}

        def zoo_init(self, model):
            return lambda seed: convert.zoo_params_from_jax(
                type(model).__name__, _jax_init_of_port_model(model, jax.random.PRNGKey(seed)),
                device="cpu")

        def directgcn_init(self, cfg):
            jcfg = j_model.DirectGCNConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                                              if k in j_fields})
            return lambda seed: convert.params_from_jax(
                j_model.init_directgcn_params(jax.random.PRNGKey(seed), jcfg), device="cpu")

        mp.setattr(t_bench.GNNBenchmarker, "_zoo_init", zoo_init)
        mp.setattr(t_bench.GNNBenchmarker, "_directgcn_init", directgcn_init)
        overrides = {"benchmark.node_classification_datasets": ["KarateClub"],
                     "benchmark.n_seeds": 1, "benchmark.test_on_undirected": False,
                     "benchmark.pca_target_dim": 8, "benchmark.norm_row_dropout": 0.0,
                     "gcn.dropout_rate": 0.0}
        out = {}
        for key, cfg_cls, make in (("jax", JConfig, lambda c: j_bench.GNNBenchmarker(c)),
                                   ("torch", TConfig,
                                    lambda c: t_bench.GNNBenchmarker(c, device="cpu"))):
            base = tmp_path_factory.mktemp(key)
            cfg = cfg_cls().apply_overrides(dict(overrides, **{"paths.base_output_dir": base}))
            out[key] = (make(cfg).run(epochs=2), base / "4_benchmarking_results")
        yield out
    finally:
        mp.undo()


def test_run_result_rows_match_jax(karate_runs):
    (j_rows, _), (t_rows, _) = karate_runs["jax"], karate_runs["torch"]
    assert [r["model"] for r in t_rows] == [r["model"] for r in j_rows]
    assert len(t_rows) == 10 and not any("error" in r for r in t_rows)
    assert t_rows == j_rows


def test_run_summary_csvs_byte_equal(karate_runs):
    (_, jdir), (_, tdir) = karate_runs["jax"], karate_runs["torch"]
    for name in ("benchmark_summary_KarateClub.csv", "gnn_benchmark_FULL_SUMMARY.csv"):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name


def test_run_history_csvs_match(karate_runs):
    (_, jdir), (_, tdir) = karate_runs["jax"], karate_runs["torch"]
    files = sorted(p.name for p in (jdir / "KarateClub_Original").glob("*_history.csv"))
    assert len(files) == 10
    assert files == sorted(p.name for p in (tdir / "KarateClub_Original").glob("*_history.csv"))
    for name in files:
        j_lines = (jdir / "KarateClub_Original" / name).read_text().splitlines()
        t_lines = (tdir / "KarateClub_Original" / name).read_text().splitlines()
        assert t_lines[0] == j_lines[0] == "epoch,loss,val_accuracy"
        assert len(t_lines) == len(j_lines) == 3
        for t_line, j_line in zip(t_lines[1:], j_lines[1:]):
            te, tl, tv = t_line.split(",")
            je, jl, jv = j_line.split(",")
            assert (te, tv) == (je, jv), name
            assert math.isclose(float(tl), float(jl), rel_tol=1e-5), name


def test_run_embeddings_and_metric_log_match(karate_runs):
    (_, jdir), (_, tdir) = karate_runs["jax"], karate_runs["torch"]
    files = sorted(p.name for p in (jdir / "KarateClub_Original").glob("*.h5"))
    assert len(files) == 20
    assert files == sorted(p.name for p in (tdir / "KarateClub_Original").glob("*.h5"))
    for name in files:
        with h5py.File(jdir / "KarateClub_Original" / name) as jf, \
                h5py.File(tdir / "KarateClub_Original" / name) as tf:
            assert sorted(jf) == sorted(tf) and len(jf) == 34
            j = np.stack([jf[k][()] for k in sorted(jf)]).astype(np.float32)
            t = np.stack([tf[k][()] for k in sorted(tf)]).astype(np.float32)
            assert tf["node_0"].dtype == jf["node_0"].dtype
            if name.endswith("_pca.h5"):
                t = t * np.where(np.sum(t * j, axis=0) < 0, -1.0, 1.0)
            np.testing.assert_allclose(t, j, rtol=2e-3, atol=2e-3 * np.abs(j).max(), err_msg=name)
    run = "run_benchmark"
    assert (json.loads((tdir / run / "params.json").read_text())
            == json.loads((jdir / run / "params.json").read_text()))
    t_log = [json.loads(ln) for ln in (tdir / run / "metrics.jsonl").read_text().splitlines()]
    j_log = [json.loads(ln) for ln in (jdir / run / "metrics.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in t_log] == [sorted(r) for r in j_log]
    drop = ("seconds", "t")  # wall clocks
    assert ([{k: v for k, v in r.items() if k not in drop} for r in t_log]
            == [{k: v for k, v in r.items() if k not in drop} for r in j_log])


def test_error_row_and_carry_on(tmp_path, monkeypatch):
    """A model that raises leaves an ``error`` row and the others run."""
    cfg = TConfig().apply_overrides({"paths.base_output_dir": tmp_path,
                                     "benchmark.save_embeddings": False,
                                     "benchmark.test_on_undirected": False,
                                     "benchmark.normalized_row": False})
    bench = t_bench.GNNBenchmarker(cfg, device="cpu")

    def broken(self, params, x, train=False, gen=None):
        raise RuntimeError("broken GIN")

    monkeypatch.setattr(t_zoo.GIN, "apply", broken)
    rows = bench.run_on_dataset_variant(t_data.karate_club(), j_bench.seeded_split(
        34, cfg.benchmark.split_ratios, 1), "_Original", tmp_path, epochs=1, seed=1)
    assert len(rows) == 9
    bad = [r for r in rows if "error" in r]
    assert bad == [{"dataset": "KarateClub_Original", "model": "GIN", "error": "broken GIN",
                    "synthetic": False}]
    assert bench.stats["KarateClub_Original"]["GIN"]["error"] == "broken GIN"
    assert bench.stats["KarateClub_Original"]["GCN"]["formats"] == ["dense"]
    assert bench.stats["KarateClub_Original"]["GAT"]["formats"] == ["edges"]


def test_cli_benchmark_stage_on_cpu(tmp_path):
    out = tmp_path / "out"
    res = t_main(["--out", str(out), "--stages", "benchmark", "--device", "cpu",
                  "--set", "benchmark.epochs=2", "--set", "benchmark.n_seeds=2",
                  "--set", 'benchmark.node_classification_datasets=["KarateClub","Cornell"]'])
    rows = res["benchmark_results"]
    assert len(rows) == 2 * 2 * 10 and not any("error" in r for r in rows)
    assert all(math.isfinite(r["test_accuracy"]) for r in rows)
    assert {r["n_seeds"] for r in rows if r["dataset"].startswith("KarateClub")} == {2}
    assert all(r["synthetic"] for r in rows if r["dataset"].startswith("Cornell"))
    root = out / "4_benchmarking_results"
    full = pd.read_csv(root / "gnn_benchmark_FULL_SUMMARY.csv")
    assert len(full) == 40
    assert (root / "Cornell_Undirected" / "ProtGramDirectGCN_norm_node_embeddings_pca.h5").exists()
    assert res["seconds"]["benchmark"] > 0
    stats = res["benchmarker"].stats
    assert set(stats) == {"KarateClub_Original", "KarateClub_Undirected", "Cornell_Original",
                          "Cornell_Undirected"}
    assert stats["KarateClub_Original"]["GCN"]["steps"] == 4
