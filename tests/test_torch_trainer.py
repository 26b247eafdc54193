"""Port parity: the train step, the trainer's helpers and ``run()``.

Three steps of the JAX package's ``make_train_step`` (optax Adam, L2 in the
gradient) against three of the port's (``make_optimizer``'s Adam) from the same
parameters and inputs, float32, dropout 0: losses held at rtol 1e-6 and
parameters at rtol 1e-4, atol 1e-5 * max|leaf| (Adam normalises each
element's step, so an element whose gradient is a cancellation residue,
summed in another order, moves by a share of lr: up to 1.2e-5 here).  The
optimizer alone, fed the same gradients, within a few float32 ulps of
optax's.  ``run()`` end to end on the CPU at narrow widths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.__main__ import main as t_main
from protgram_directgcn_torch.config import Config as TConfig
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder as TBuilder
from protgram_directgcn_torch.models import directgcn as t_model
from protgram_directgcn_torch.ops import spmm as t_spmm
from protgram_directgcn_torch.pipeline import trainer as t_trainer
from protgram_directgcn_torch.pipeline.labels import next_node_labels
from protgram_directgcn_torch.utils.io import parse_fasta
from protgram_directgcn_tpu.config import Config as JConfig
from protgram_directgcn_tpu.graph.builder import NgramGraphBuilder as JBuilder
from protgram_directgcn_tpu.models import directgcn as j_model
from protgram_directgcn_tpu.pipeline import trainer as j_trainer
from tests.test_torch_graph import write_seeded_fasta

SEQS = [
    ("P1", "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"),
    ("P2", "MKLVTAYIAKQRRQISFVK"),
    ("P3", "GLIEVQAPILSRVGDGTQDNLSGAEKAVQ"),
]


@pytest.fixture(scope="module")
def graphs():
    return JBuilder(n_max=3).build_from_sequences(SEQS), TBuilder(n_max=3).build_from_sequences(SEQS)


def _leaves(tree, path=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [lp for k in sorted(tree) for lp in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [lp for i, v in enumerate(tree) for lp in _leaves(v, path + (i,))]
    return [(path, tree)]


@pytest.mark.parametrize("kind", ["dense", "hypercube", "ell"])
@pytest.mark.parametrize("l2_lambda,wd", [(1e-3, 0.0), (0.0, 1e-2)])
def test_three_train_steps_match(monkeypatch, graphs, kind, l2_lambda, wd):
    """"ell": the port under spmm_mode="pallas" (ELL operators through the
    kernels' entry points, ``spmm._on_card`` made true) against the JAX
    package under spmm_mode="ell"."""
    jg, tg = graphs
    if kind == "ell":
        monkeypatch.setattr(t_spmm, "_on_card", lambda t: True)
    level = 1 if kind == "dense" else 3
    j_dev = jg[level - 1].to_device(mode=kind)
    t_dev = tg[level - 1].to_device(mode="pallas" if kind == "ell" else kind, device="cpu")
    n, real = t_dev.num_nodes, tg[level - 1].num_nodes
    dims = (10, 8, 6)
    common = dict(layer_dims=dims, num_nodes=n, num_classes=real, n_gram_len=level,
                  one_gram_dim=dims[0] if level == 1 else 0, max_pe_len=8,
                  dropout=0.0, decoder_dropout=0.0)
    jcfg = j_model.DirectGCNConfig(**common)
    tcfg = t_model.DirectGCNConfig(**common)
    rng = np.random.default_rng(level)
    x = rng.normal(size=(n, dims[0])).astype(np.float32)
    y = np.zeros(n, np.int64)
    mask = np.zeros(n, np.float32)
    labels, _ = next_node_labels(tg[level - 1])
    node_map = np.arange(real) if t_dev.node_map is None else t_dev.node_map.numpy()
    y[node_map] = labels
    mask[node_map] = 1.0

    jp = j_model.init_directgcn_params(jax.random.PRNGKey(4), jcfg)
    tp = convert.params_from_jax(jp, device="cpu")
    for p in t_model.param_leaves(tp):
        p.requires_grad_(True)
    opt_j = j_trainer.make_optimizer(1e-2, wd)
    opt_state = opt_j.init(jp)
    step_j = j_trainer.make_train_step(jcfg, opt_j, l2_lambda)
    step_t = t_trainer.make_train_step(tcfg, t_trainer.make_optimizer(tp, 1e-2, wd), l2_lambda)
    xt, yt, mt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    for _ in range(3):
        jp, opt_state, j_loss, j_primary = step_j(
            jp, opt_state, j_dev, jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(mask),
            jnp.float32(1.0), jax.random.PRNGKey(0), None)
        t_loss, t_primary = step_t(tp, t_dev, xt, yt, mt, 1.0, None)
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
        np.testing.assert_allclose(float(t_primary), float(j_primary), rtol=1e-6)
    j_leaves = dict(_leaves(jp))
    for path, t in _leaves(tp):
        j = np.asarray(j_leaves[path]).reshape(tuple(t.shape))
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(j).max())),
                                   err_msg=str(path))


@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_three_adam_steps_within_ulps_of_jax(wd):
    """The trainer's Adam and the JAX trainer's (optax) on the same
    gradients from zero parameters, three steps, not reset between steps:
    each leaf within 2 ulps of its largest magnitude a step taken.  The
    bias corrections are float32, as optax's: float64 ones put the
    parameters 70-130 such ulps off at the first step."""
    rng = np.random.default_rng(7)
    shapes = {"w1": (64, 40), "b1": (40,), "w2": (40, 3)}
    tree = {"decoder": {k: np.zeros(s, np.float32) for k, s in shapes.items()}}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = convert.params_from_jax(tree, device="cpu")
    j_opt = j_trainer.make_optimizer(1e-2, wd)
    state = j_opt.init(jp)
    t_opt = t_trainer.make_optimizer(tp, 1e-2, wd)
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        upd, state = j_opt.update({"decoder": jax.tree_util.tree_map(jnp.asarray, grads)},
                                  state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp["decoder"].items():
            t.grad = torch.from_numpy(grads[k])
        t_opt.step()
        for k, t in tp["decoder"].items():
            j = np.asarray(jp["decoder"][k])
            ulp = np.spacing(np.abs(j).max())
            assert np.abs(t.numpy() - j).max() <= 2 * (step + 1) * ulp, (step, k)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_initial_features_match(graphs, level):
    jg, tg = graphs
    jt = j_trainer.HierarchicalTrainer(JConfig())
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    if level == 1:
        prev_vocab = prev = None
    else:
        prev_vocab = tg[level - 2].vocab
        prev = np.random.default_rng(0).normal(size=(len(prev_vocab), 4)).astype(np.float32)
    xj = jt._initial_features(jg[level - 1], prev_vocab, prev, seed=9)
    xt = tt._initial_features(tg[level - 1], prev_vocab, prev, seed=9)
    np.testing.assert_array_equal(xt, xj)


def test_plateau_scheduler_and_early_stopper_match():
    losses = [5.0, 4.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 3.0, 3.0, 3.0, 3.0, 3.0]
    js, ts = j_trainer.PlateauScheduler(1.0, 2, 0.5), t_trainer.PlateauScheduler(1.0, 2, 0.5)
    je, te = j_trainer.EarlyStopper(3, 1e-3), t_trainer.EarlyStopper(3, 1e-3)
    for loss in losses:
        assert ts.step(loss) == js.step(loss)
        assert te.should_stop(loss) == je.should_stop(loss)


def test_level_routes_and_plan(graphs):
    _, tg = graphs
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    plan = tt._level_plan(tg[2], 16)
    assert isinstance(plan, t_trainer.LevelPlan) and plan.tier == 0
    assert plan.bank_budget >= tt._MIN_BANK
    assert tt._to_device_graph(tg[0], plan).route == "dense"
    # The trigram toy graph's hypercube is > 4x its vocabulary: dense unless forced.
    assert tt._to_device_graph(tg[2], plan).route == "dense"
    tt.gcn.spmm_mode = "hypercube"
    assert tt._to_device_graph(tg[2], plan).route == "hypercube"
    for mode in ("ell", "pallas"):  # "pallas" builds ELL operators (trainer.py:1610)
        tt.gcn.spmm_mode = mode
        assert [tt._to_device_graph(g, plan).route for g in tg] == ["ell"] * 3


@pytest.mark.parametrize("knob,value", [
    ("compute_dtype", "bfloat16"), ("node_param_dtype", "bfloat16"),
    ("node_param_factored", "on"), ("remat", True),
])
def test_level_plan_refuses_unported_tiers(graphs, knob, value):
    """An explicit knob sets its field of the plan.  Where no tier fits,
    not even tier 4 at degraded dims (2 GiB: less than the plan's slack and
    bank floor), the port raises the JAX package's ValueError (same
    opening), naming the configured dims."""
    jg, tg = graphs
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    jt = j_trainer.HierarchicalTrainer(JConfig())
    setattr(tt.gcn, knob, value)
    setattr(jt.gcn, knob, value)
    plan = tt._level_plan(tg[2], 16)
    field = "factored" if knob == "node_param_factored" else knob
    assert getattr(plan, field) == (True if value == "on" else value)
    tt._hbm_override = jt._hbm_override = 2 << 30
    with pytest.raises(ValueError) as t_exc:
        tt._level_plan(tg[2], 16)
    with pytest.raises(ValueError) as j_exc:
        jt._level_plan(jg[2], 16)
    head = "level n=3: gcn.hidden_layer_dims=[256, 128, 64] does not fit 2.0 GB at any memory tier"
    assert str(t_exc.value).startswith(head) and str(j_exc.value).startswith(head)


def test_level_plan_raises_when_tier0_does_not_fit(graphs):
    _, tg = graphs
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    tt._hbm_override = 1 << 30
    with pytest.raises(ValueError, match="does not fit 1.0 GB at any memory tier"):
        tt._level_plan(tg[2], 16)


def test_level_plan_sizes_the_logits_by_the_task(graphs):
    """The logits take num_classes columns: one per node under next_node
    (the default), k + 1 = 4 under closest_aa."""
    _, tg = graphs
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    g3 = tg[2]
    _, alpha = t_trainer.vocab_char_codes(g3.vocab)
    need = sum(tt._residency(alpha**3, 16, 4)) + tt._PLAN_SLACK + tt._MIN_BANK
    tt._hbm_override = need
    plan = tt._level_plan(g3, 16, num_classes=4)
    assert plan.tier == 0 and plan.bank_budget == tt._MIN_BANK
    # One logit column per node does not fit tier 0 there: the plan escalates.
    assert tt._level_plan(g3, 16).tier > 0


def _small_cfg(tmp_path, fasta):
    cfg = TConfig()
    cfg.apply_overrides({
        "gcn.hidden_layer_dims": [12, 8], "gcn.one_gram_init_dim": 16,
        "gcn.epochs_per_level": 3, "gcn.run_sanity_check_ppi": False,
    })
    cfg.paths.input_fasta = fasta
    cfg.paths.base_output_dir = tmp_path / "out"
    return cfg


def test_run_end_to_end_on_cpu(tmp_path):
    fasta = write_seeded_fasta(tmp_path / "seq.fasta", n_seqs=80, lo=40, hi=120)
    cfg = _small_cfg(tmp_path, fasta)
    TBuilder(cfg).run()
    tt = t_trainer.HierarchicalTrainer(cfg, device="cpu")
    path = tt.run()
    pooled = tt.pooled
    assert path.endswith("gcn_n3_embeddings_pca8.h5")
    assert len(pooled) == 80
    vecs = np.stack(list(pooled.values()))
    assert vecs.shape == (80, 8) and np.isfinite(vecs).all()
    assert [tt.level_stats[n]["route"] for n in (1, 2, 3)] == ["dense", "hypercube", "hypercube"]
    for n in (1, 2, 3):
        st = tt.level_stats[n]
        assert st["epochs"] == 3 and np.isfinite(st["losses"]).all()
        assert (cfg.paths.gcn_embeddings_dir / "level_checkpoints" / f"level_{n}.npz").exists()
    # A second run resumes every level from its checkpoint and pools the same.
    again = t_trainer.HierarchicalTrainer(cfg, device="cpu")
    again.run()
    pooled2 = again.pooled
    assert again.level_stats == {}
    for k in pooled:
        np.testing.assert_array_equal(pooled2[k], pooled[k])


def test_run_ell_path_on_cpu(tmp_path):
    """The ELL path end to end: spmm_mode="pallas" at n = 1..4, cluster
    training off, closest_aa labels at n = 4 (the full-batch ELL path that
    ``chip_smoke.run_ell_path`` times)."""
    fasta = write_seeded_fasta(tmp_path / "seq.fasta", n_seqs=40, lo=40, hi=120)
    cfg = _small_cfg(tmp_path, fasta)
    cfg.apply_overrides({"graph_builder.ngram_max_n": 4, "gcn.spmm_mode": "pallas",
                         "gcn.use_cluster_training": False,
                         "gcn.default_task_type": "closest_aa"})
    TBuilder(cfg).run()
    tt = t_trainer.HierarchicalTrainer(cfg, device="cpu")
    tt.run()
    pooled = tt.pooled
    assert len(pooled) == 40
    vecs = np.stack(list(pooled.values()))
    assert vecs.shape == (40, 8) and np.isfinite(vecs).all()
    assert [tt.level_stats[n]["route"] for n in (1, 2, 3, 4)] == ["ell"] * 4
    for n in (1, 2, 3, 4):
        st = tt.level_stats[n]
        assert st["epochs"] == 3 and np.isfinite(st["losses"]).all()
        assert st["device_nodes"] == st["nodes"]  # no padded node space off the hypercube
        # CPU tensors take the plain versions: no kernel launch is counted.
        assert all(v == 0 for per_dir in st["launches"].values() for v in per_dir.values())


@pytest.mark.parametrize("feat_dim", [4, 64, 256])
@pytest.mark.parametrize("level", [2, 3])
def test_hypercube_failure_falls_back_like_jax(tmp_path, monkeypatch, level, feat_dim):
    """When the hypercube cannot be built, both trainers fall back to
    ``graph.to_device(mode="auto", feat_dim=...)`` (trainer.py:1626-1633)
    and take the same format, the block format included."""
    from protgram_directgcn_torch.ops import hypercube as t_hyper
    from protgram_directgcn_tpu.ops import block as j_block
    from protgram_directgcn_tpu.ops import hypercube as j_hyper

    def fail_t(*a, **k):
        raise t_trainer.BlockStructureError("forced")

    def fail_j(*a, **k):
        raise j_block.BlockStructureError("forced")

    monkeypatch.setattr(t_hyper, "build_hypercube", fail_t)
    monkeypatch.setattr(j_hyper, "build_hypercube", fail_j)
    fasta = write_seeded_fasta(tmp_path / "seq.fasta", n_seqs=80, lo=40, hi=120)
    seqs = list(parse_fasta(fasta))
    jgraph = JBuilder(n_max=level).build_from_sequences(seqs)[level - 1]
    tgraph = TBuilder(n_max=level).build_from_sequences(seqs)[level - 1]
    want = type(j_trainer.HierarchicalTrainer(JConfig())._to_device_graph(jgraph, feat_dim).p_in)
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    plan = tt._level_plan(tgraph, feat_dim)
    assert type(tt._to_device_graph(tgraph, plan, feat_dim).p_in).__name__ == want.__name__


def test_cli_graph_and_gcn_on_cpu(tmp_path):
    fasta = write_seeded_fasta(tmp_path / "seq.fasta", n_seqs=30, lo=20, hi=60)
    result = t_main([
        "--fasta", str(fasta), "--out", str(tmp_path / "out"), "--stages", "graph,gcn",
        "--set", "gcn.hidden_layer_dims=[8,4]", "--set", "gcn.one_gram_init_dim=8",
        "--set", "gcn.epochs_per_level=2", "--set", "gcn.run_sanity_check_ppi=false",
        "--device", "cpu",
    ])
    assert len(result["graphs"]) == 3
    assert len(result["pooled"]) == 30
    assert all(np.isfinite(v).all() and v.shape == (4,) for v in result["pooled"].values())
    only_graph = t_main(["--fasta", str(fasta), "--out", str(tmp_path / "g"), "--stages",
                         "graph"])
    assert only_graph["trainer"] is None and len(only_graph["graphs"]) == 3
    with pytest.raises(NotImplementedError):
        t_main(["--fasta", str(fasta), "--stages", "graph,gcn,transformer", "--device", "cpu"])


def test_hypercube_over_budget_falls_back_to_dense(tmp_path):
    fasta = write_seeded_fasta(tmp_path / "seq.fasta", n_seqs=80, lo=40, hi=120)
    graph = TBuilder(n_max=2).build_from_sequences(list(parse_fasta(fasta)))[1]
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    plan = tt._level_plan(graph, 16)
    assert tt._to_device_graph(graph, plan).route == "hypercube"
    tiny = dataclasses.replace(plan, bank_budget=1024)
    assert tt._to_device_graph(graph, tiny).route == "dense"
    tt.gcn.spmm_mode = "hypercube"
    with pytest.raises(t_trainer.BlockStructureError):
        tt._to_device_graph(graph, tiny)


def test_cluster_training_is_refused_off_the_hypercube(graphs):
    """Cluster training, which this test once found refused, now takes the
    level off the hypercube above the threshold (``route == "cluster"``), and the
    hypercube route still trains full batch (``cluster_auto_fullbatch``)."""
    _, tg = graphs
    cfg = TConfig()
    cfg.apply_overrides({"gcn.cluster_training_threshold_nodes": 10,
                         "gcn.target_nodes_per_cluster": 10,
                         "gcn.hidden_layer_dims": [4], "gcn.epochs_per_level": 1})
    tt = t_trainer.HierarchicalTrainer(cfg, device="cpu")
    g3 = tg[2]  # off the hypercube: its hypercube is > 4x the vocabulary
    x = np.zeros((g3.num_nodes, 4), np.float32)
    y, classes = next_node_labels(g3)
    _, emb, _, dev_graph = tt.train_level(g3, x, y, classes)
    st = tt.level_stats[3]
    assert dev_graph.route != "hypercube" and st["route"] == "cluster"
    assert st["clusters"] == -(-g3.num_nodes // 10) and st["steps"] == st["clusters"]
    assert st["block_format"] == "dense" and st["resident"]
    assert emb.shape == (g3.num_nodes, 4) and np.isfinite(emb).all()
    tt.gcn.spmm_mode = "hypercube"  # full batch on the hypercube route
    _, emb, _, _ = tt.train_level(g3, x, y, classes)
    assert tt.level_stats[3]["route"] == "hypercube" and tt.level_stats[3]["steps"] == 1
    assert emb.shape == (g3.num_nodes, 4) and np.isfinite(emb).all()
