"""Port parity: PPI link-prediction evaluation (``pipeline/ppi.py``), its
pair loading, embedding store and edge features, and the CLI's new stages.

- ``load_interaction_pairs`` / ``stream_interaction_pairs`` (with and
  without sampling) and ``get_required_ids_from_files``: equal to the JAX
  package's, pair for pair and in order.
- ``EmbeddingStore`` and ``check_h5_integrity`` on H5 and ``.npz``.
- The five edge methods: ``make_edge_feature`` bit-equal to the JAX
  package's, ``edge_features`` (device tensors) bit-equal to it, and
  ``generate_edge_features_batched`` batch for batch.
- ``PPIPipeline.run(use_dummy_data=True)``, 3 folds, 4 epochs, in memory
  (the card-side layout, on CPU tensors) and streaming (host LRU and per
  batch build), against the JAX package's ``run``: every fold's metrics
  within 1e-5 (absolute).  JAX's dropout cannot be replayed, so the test
  replaces both packages' ``MLPTrainer`` by one with dropout 0, and the
  port's starts from the JAX initial parameters of the same seed
  (``convert.mlp_params_from_jax``); neither package's code changes.
- ``run_sanity_check_ppi`` against the JAX package's on the same files
  (metrics within 1e-5), from an H5 and an ``.npz`` store.
- Discovery of ``.npz`` sets, and the CLI's ``--stages
  graph,gcn,word2vec,ppi --device cpu`` on a toy FASTA writing
  ``ppi_results.json``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.__main__ import main as t_main
from protgram_directgcn_torch.config import Config as TConfig
from protgram_directgcn_torch.models import mlp as t_mlp
from protgram_directgcn_torch.pipeline import ppi as t_ppi
from protgram_directgcn_torch.utils import embeddings as t_emb
from protgram_directgcn_torch.utils import io as t_io
from protgram_directgcn_tpu.config import Config as JConfig
from protgram_directgcn_tpu.models import mlp as j_mlp
from protgram_directgcn_tpu.pipeline import ppi as j_ppi
from protgram_directgcn_tpu.utils import embeddings as j_emb
from protgram_directgcn_tpu.utils import io as j_io
from protgram_directgcn_tpu.utils.metrics import read_metrics
from tests.test_torch_graph import write_seeded_fasta

METHODS = ("concatenate", "average", "hadamard", "l1_distance", "l2_distance")


def _write_pairs(path, rng, n, ids, sep=","):
    with open(path, "w") as f:
        f.write("protein_a,protein_b\n" if sep == "," else "")
        for _ in range(n):
            a, b = rng.choice(ids, 2, replace=False)
            f.write(f'"{a}"{sep}{b}\n' if rng.random() < 0.2 else f"{a}{sep}{b}\n")
        f.write("\n,\nonly_one\n")


@pytest.mark.parametrize("sep", [",", "\t"])
@pytest.mark.parametrize("sample_n", [None, 0, 17, 60, 500])
def test_pair_loading_matches_jax(tmp_path, sep, sample_n):
    rng = np.random.default_rng(5)
    ids = [f"P{i:03d}" for i in range(30)]
    path = tmp_path / "pairs.csv"
    _write_pairs(path, rng, 80, ids, sep)
    for label in (0, 1):
        assert (t_io.load_interaction_pairs(path, label, sample_n, 7)
                == j_io.load_interaction_pairs(path, label, sample_n, 7))
        for bs in (1, 16, 1000):
            assert (list(t_io.stream_interaction_pairs(path, label, bs, sample_n, 7))
                    == list(j_io.stream_interaction_pairs(path, label, bs, sample_n, 7)))
    assert (t_io.get_required_ids_from_files([path, tmp_path / "absent.csv"])
            == j_io.get_required_ids_from_files([path, tmp_path / "absent.csv"]))
    assert t_io.load_interaction_pairs(tmp_path / "absent.csv", 1) == []
    assert list(t_io.stream_interaction_pairs(tmp_path / "absent.csv", 1, 4)) == []


def _embeddings(n=12, dim=6, seed=0):
    rng = np.random.default_rng(seed)
    return {f"Q{i:02d}": rng.normal(size=dim).astype(np.float32) for i in range(n)}


@pytest.mark.parametrize("h5", [True, False])
def test_embedding_store_and_integrity(tmp_path, monkeypatch, h5):
    if not h5:
        monkeypatch.setattr(t_io, "h5py", None)
    emb = _embeddings()
    path = t_io.write_embeddings(tmp_path / "e.h5", emb)
    assert path.endswith(".h5" if h5 else ".npz")
    with t_io.EmbeddingStore(path) as store:
        assert len(store) == len(emb) and store.get_keys() == set(emb)
        assert "Q03" in store and "nope" not in store
        for k, v in emb.items():
            assert store[k].dtype == np.float16
            np.testing.assert_array_equal(store[k], v.astype(np.float16))
        with pytest.raises(KeyError):
            store["nope"]
    with pytest.raises(RuntimeError):
        store["Q01"]
    with pytest.raises(FileNotFoundError):
        t_io.EmbeddingStore(tmp_path / "absent.npz").__enter__()
    assert t_io.check_h5_integrity(path)
    if h5:
        assert j_io.check_h5_integrity(path)
    bad = dict(emb, Q05=np.full(6, np.nan, np.float32))
    assert not t_io.check_h5_integrity(t_io.write_embeddings(tmp_path / "bad.h5", bad),
                                       num_samples=len(bad))
    assert not t_io.check_h5_integrity(tmp_path / "absent.h5")


@pytest.mark.parametrize("method", METHODS + ("unknown",))
def test_edge_methods_bit_equal(method):
    rng = np.random.default_rng(11)
    a = (rng.normal(size=(64, 20)) * 3).astype(np.float16)
    b = (rng.normal(size=(64, 20)) * 3).astype(np.float16)
    want = np.stack([j_emb.make_edge_feature(x, y, method) for x, y in zip(a, b)])
    host = np.stack([t_emb.make_edge_feature(x, y, method) for x, y in zip(a, b)])
    dev = t_emb.edge_features(torch.from_numpy(a), torch.from_numpy(b), method).numpy()
    assert host.dtype == want.dtype == dev.dtype == np.float16
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev, want)
    emb = {f"P{i}": v for i, v in enumerate(a)}
    emb["short"] = a[0][:5]
    pairs = [(f"P{i}", f"P{(i * 7) % 64}", i % 2) for i in range(64)] + [("P1", "short", 1),
                                                                       ("P1", "absent", 0)]
    got = list(t_emb.generate_edge_features_batched(pairs, emb, method, 10, 20))
    ref = list(j_emb.generate_edge_features_batched(pairs, emb, method, 10, 20))
    assert len(got) == len(ref) == 7
    for (gx, gy), (rx, ry) in zip(got, ref):
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gy, ry)


def test_residue_pooling_and_l2_normalize_match_jax():
    res = np.random.default_rng(2).normal(size=(9, 5)).astype(np.float32)
    for strategy in ("mean", "sum", "max"):
        np.testing.assert_array_equal(t_emb.pool_residue_embeddings(res, strategy),
                                      j_emb.pool_residue_embeddings(res, strategy))
    np.testing.assert_array_equal(t_emb.pool_residue_embeddings(res[:0], "mean", 5), np.zeros(5))
    np.testing.assert_array_equal(t_emb.l2_normalize(res), j_emb.l2_normalize(res))
    np.testing.assert_array_equal(t_emb.l2_normalize(res[0]), j_emb.l2_normalize(res[0]))


class _JNoDropout(j_mlp.MLPTrainer):
    def __init__(self, cfg, seed=42):
        super().__init__(dataclasses.replace(cfg, dropout1_rate=0.0, dropout2_rate=0.0), seed)


class _TNoDropout(t_mlp.MLPTrainer):
    """Dropout 0, from the JAX initial parameters of the same seed."""

    def __init__(self, cfg, seed=42, device="cuda"):
        cfg = dataclasses.replace(cfg, dropout1_rate=0.0, dropout2_rate=0.0)
        super().__init__(cfg, seed, device)
        jparams = j_mlp.init_mlp_params(jax.random.PRNGKey(seed),
                                        j_mlp.MLPConfig(**dataclasses.asdict(cfg)))
        self.set_params(convert.mlp_params_from_jax(jparams, device=self.device))


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(j_ppi, "MLPTrainer", _JNoDropout)
    monkeypatch.setattr(t_ppi, "MLPTrainer", _TNoDropout)


def _configs(tmp_path, **eval_overrides):
    out = []
    for cls, sub in ((JConfig, "j"), (TConfig, "t")):
        cfg = cls()
        cfg.paths.base_output_dir = tmp_path / sub
        cfg.eval.n_folds = 3
        cfg.eval.epochs = 4
        cfg.eval.batch_size = 32
        cfg.eval.early_stopping_patience = 2
        for k, v in eval_overrides.items():
            setattr(cfg.eval, k, v)
        out.append(cfg)
    return out


def _fold_records(run_dir):
    return [r for r in read_metrics(run_dir) if "fold" in r]


@pytest.mark.parametrize("case", ["memory", "streaming", "standardize", "hadamard"])
def test_ppi_run_matches_jax(tmp_path, no_dropout, case):
    overrides = {"plot_training_history": case == "memory"}
    if case == "streaming":
        overrides["max_in_memory_feature_bytes"] = 1
    elif case == "standardize":
        overrides["standardize_features"] = True
    elif case == "hadamard":
        overrides["edge_embedding_method"] = "hadamard"
    jcfg, tcfg = _configs(tmp_path, **overrides)
    want = j_ppi.PPIPipeline(jcfg).run(use_dummy_data=True, output_dir=tmp_path / "j" / "eval")
    pipe = t_ppi.PPIPipeline(tcfg, device="cpu")
    got = pipe.run(use_dummy_data=True, output_dir=tmp_path / "t" / "eval")
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert g.keys() == w.keys() and g["n_folds"] == w["n_folds"] == 3
    for key in w:
        if key.startswith("test_") or key.startswith("fold_"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-5, err_msg=key)
    for gr, wr in zip(_fold_records(tmp_path / "t" / "eval" / "run_ppi"),
                      _fold_records(tmp_path / "j" / "eval" / "run_ppi")):
        assert gr.keys() == wr.keys() and gr["fold"] == wr["fold"]
        for key in gr:
            if key not in ("fold", "t") and isinstance(gr[key], float):
                np.testing.assert_allclose(gr[key], wr[key], rtol=0, atol=1e-5, err_msg=key)
    for fpr_tpr_g, fpr_tpr_w in zip(g["roc_data_representative"], w["roc_data_representative"]):
        np.testing.assert_allclose(fpr_tpr_g, fpr_tpr_w, atol=1e-12)
    saved = json.loads((tmp_path / "t" / "eval" / "ppi_results.json").read_text())
    assert saved[0]["embedding_name"] == "DummyEmbeddings" and "roc_data_representative" not in saved[0]
    assert (tmp_path / "t" / "eval" / "evaluation_summary.txt").exists()
    assert pipe.stats["DummyEmbeddings"]["steps"] > 0
    if case == "memory":
        assert (tmp_path / "t" / "eval" / "plots" / "history_DummyEmbeddings_fold1.png").exists()
        assert (tmp_path / "t" / "eval" / "plots" / "comparison_roc_curves.png").exists()


@pytest.mark.parametrize("h5", [True, False])
def test_sanity_check_matches_jax(tmp_path, monkeypatch, no_dropout, h5):
    jcfg, tcfg = _configs(tmp_path)
    emb, pos, neg = j_ppi.create_dummy_data(tmp_path / "d", num_proteins=40, num_pairs=120, seed=1)
    for cfg in (jcfg, tcfg):
        cfg.paths.interactions_positive = pos
        cfg.paths.interactions_negative = neg
        cfg.gcn.sanity_check_epochs = 3
    want = j_ppi.run_sanity_check_ppi(jcfg, emb)
    path = emb
    if not h5:
        monkeypatch.setattr(t_io, "h5py", None)
        with j_io.EmbeddingStore(emb) as store:
            vectors = {k: store[k] for k in store.get_keys()}
        path = t_io.write_embeddings(tmp_path / "d" / "same.h5", vectors)
        assert path.endswith(".npz")
    stats = {}
    got = t_ppi.run_sanity_check_ppi(tcfg, path, device="cpu", stats=stats)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5, err_msg=key)
    assert stats["steps"] == 3 * 6 and stats["test_pairs"] == 48 and stats["pairs"] == 240


def test_sanity_check_skips_like_jax(tmp_path):
    jcfg, tcfg = _configs(tmp_path)
    emb, _, _ = j_ppi.create_dummy_data(tmp_path / "d", seed=2)
    for cfg in (jcfg, tcfg):
        cfg.paths.interactions_positive = tmp_path / "nope_pos.csv"
        cfg.paths.interactions_negative = tmp_path / "nope_neg.csv"
    assert j_ppi.run_sanity_check_ppi(jcfg, emb) is None
    assert t_ppi.run_sanity_check_ppi(tcfg, emb, device="cpu") is None
    assert t_ppi.run_sanity_check_ppi(tcfg, tmp_path / "absent.npz", device="cpu") is None


def test_dummy_data_matches_jax(tmp_path, monkeypatch):
    j_paths = j_ppi.create_dummy_data(tmp_path / "j", seed=9)
    monkeypatch.setattr(t_io, "h5py", None)
    t_paths = t_ppi.create_dummy_data(tmp_path / "t", seed=9)
    assert t_paths[0].endswith(".npz")
    for jp, tp in zip(j_paths[1:], t_paths[1:]):
        assert open(jp).read() == open(tp).read()
    with j_io.EmbeddingStore(j_paths[0]) as js, t_io.EmbeddingStore(t_paths[0]) as ts:
        assert js.get_keys() == ts.get_keys()
        for k in js.get_keys():
            np.testing.assert_array_equal(js[k], ts[k])


def test_discovery_reads_npz_and_skips_the_model_file(tmp_path, monkeypatch):
    monkeypatch.setattr(t_io, "h5py", None)
    cfg = TConfig()
    cfg.paths.base_output_dir = tmp_path
    emb = _embeddings()
    for d, name in ((cfg.paths.gcn_embeddings_dir, "gcn_n3_embeddings.h5"),
                    (cfg.paths.gcn_embeddings_dir, "gcn_n3_embeddings_pca8.h5"),
                    (cfg.paths.word2vec_embeddings_dir, "word2vec_dim6_mean.h5")):
        t_io.write_embeddings(d / name, emb)
    np.savez(cfg.paths.word2vec_embeddings_dir / "word2vec_model_dim6.npz", vocab=np.array(["A"]),
             vectors=np.zeros((1, 6)))
    found = t_ppi.PPIPipeline(cfg, device="cpu")._discover_embedding_files()
    assert [(f["name"], f["path"].name) for f in found] == [
        ("ProtGramDirectGCN", "gcn_n3_embeddings.npz"),
        ("ProtGramDirectGCN_PCA", "gcn_n3_embeddings_pca8.npz"),
        ("Word2Vec", "word2vec_dim6_mean.npz")]


def test_cli_graph_gcn_word2vec_ppi_on_cpu(tmp_path):
    fasta = write_seeded_fasta(tmp_path / "seq.fasta", n_seqs=30, lo=20, hi=60)
    rng = np.random.default_rng(0)
    ids = [f"Q{i:05d}" for i in range(30)]
    _write_pairs(tmp_path / "pos.csv", rng, 120, ids)
    _write_pairs(tmp_path / "neg.csv", rng, 240, ids)
    result = t_main([
        "--fasta", str(fasta), "--out", str(tmp_path / "out"),
        "--stages", "graph,gcn,word2vec,ppi", "--device", "cpu",
        "--set", "gcn.hidden_layer_dims=[8,4]", "--set", "gcn.one_gram_init_dim=8",
        "--set", "gcn.epochs_per_level=2", "--set", "gcn.sanity_check_epochs=2",
        "--set", f"paths.interactions_positive={tmp_path / 'pos.csv'}",
        "--set", f"paths.interactions_negative={tmp_path / 'neg.csv'}",
        "--set", "word2vec.vector_size=8", "--set", "word2vec.epochs=1",
        "--set", "word2vec.batch_size=64", "--set", "eval.epochs=2", "--set", "eval.n_folds=2",
        "--set", "eval.plot_training_history=false",
    ])
    assert result["trainer"].sanity_metrics is not None
    assert np.isfinite(result["trainer"].sanity_metrics["auc"])
    assert result["word2vec_path"].endswith("word2vec_dim8_mean.h5")
    names = [r["embedding_name"] for r in result["ppi_results"]]
    assert names == ["ProtGramDirectGCN", "ProtGramDirectGCN_PCA", "Word2Vec", "Word2Vec_PCA"]
    saved = json.loads((tmp_path / "out" / "3_evaluation_results" / "ppi_results.json").read_text())
    assert [r["embedding_name"] for r in saved] == names
    assert all(np.isfinite(r["test_auc"]) for r in saved)
    assert set(result["seconds"]) == {"graph", "gcn", "word2vec", "ppi"}
    dummy = t_main(["--out", str(tmp_path / "dummy"), "--stages", "dummy", "--device", "cpu",
                    "--set", "eval.epochs=1", "--set", "eval.n_folds=2",
                    "--set", "eval.plot_training_history=false"])
    assert dummy["graphs"] is None and dummy["trainer"] is None
    assert [r["embedding_name"] for r in dummy["ppi_results"]] == ["DummyEmbeddings"]
