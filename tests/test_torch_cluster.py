"""Port parity: Cluster-GCN batches, the model on a batch and clustered
training.

- ``_make_cluster_batches``: every field of every batch equal to the JAX
  package's (dense ``at`` and ELL ``idx/w/idx_t/w_t`` exact, x, y, mask,
  ``weight_factor``, ``original_indices``), in the dense and the ELL block
  format, with and without a node map; and the same resident/streamed
  decision at a device budget between the two formats' totals.
- ``directgcn_apply`` with ``original_indices``: forward and gradients
  against the JAX package's, with vector gates and with the constant
  stored rg, float32, rtol 1e-5 (atol 1e-6, and for a gradient 1e-6 x
  max|grad of that leaf|: float32 sums in another order).
- Three clustered epochs through both trainers' ``train_level`` from the
  same parameters (injected with ``convert.py``), dropout 0, the default
  learning rate 1e-3: every batch's loss and the epoch losses at rtol 1e-5;
  the final parameters at rtol 1e-5 with atol 1e-6 x max|leaf| plus
  ``ADAM_DRIFT`` x lr x steps.  Adam normalises each element's step, so
  float32 rounding in a gradient that is a cancellation residue changes
  that element's moments and, from then on, each of its steps by a share
  of lr: on the n = 3 level one gate's gradient was -3.8e-6 at one step
  (its other steps saw only the L2 term, 2e-7), and the two packages'
  values of it drew apart by ~1.1e-3 x lr a step after it, 6.5e-5 after
  66 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.config import Config as TConfig
from protgram_directgcn_torch.graph import transforms as t_transforms
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder as TBuilder
from protgram_directgcn_torch.models import directgcn as t_model
from protgram_directgcn_torch.ops.spmm import DenseAdj
from protgram_directgcn_torch.pipeline import trainer as t_trainer
from protgram_directgcn_torch.pipeline.labels import next_node_labels
from protgram_directgcn_torch.utils.io import parse_fasta
from protgram_directgcn_tpu.config import Config as JConfig
from protgram_directgcn_tpu.graph import transforms as j_transforms
from protgram_directgcn_tpu.graph.builder import NgramGraphBuilder as JBuilder
from protgram_directgcn_tpu.models import directgcn as j_model
from protgram_directgcn_tpu.pipeline import trainer as j_trainer
from tests.test_torch_graph import write_seeded_fasta

RTOL, ATOL = 1e-5, 1e-6
ADAM_DRIFT = 2e-3  # of the learning rate a step (see the module docstring)


@pytest.fixture(scope="module")
def levels(tmp_path_factory):
    """Levels 1-3 of a seeded FASTA as each package builds them."""
    fasta = write_seeded_fasta(tmp_path_factory.mktemp("cluster") / "seq.fasta", n_seqs=12,
                               lo=10, hi=30)
    seqs = list(parse_fasta(fasta))
    return (JBuilder(n_max=3).build_from_sequences(seqs),
            TBuilder(n_max=3).build_from_sequences(seqs))


def _trainers(**gcn):
    """Both trainers with the cluster knobs of tests/test_trainer.py:93-99."""
    jt = j_trainer.HierarchicalTrainer(JConfig())
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    knobs = dict(use_cluster_training=True, cluster_training_threshold_nodes=5,
                 target_nodes_per_cluster=10, min_clusters=2)
    knobs.update(gcn)
    for tr in (jt, tt):
        for k, v in knobs.items():
            setattr(tr.gcn, k, v)
    return jt, tt


def _arrays(batch):
    """A batch's fields by name, as numpy."""
    g = batch.graph
    out = {}
    for name in ("p_in", "p_out", "p_und"):
        m = getattr(g, name)
        fields = ("at",) if type(m).__name__ == "DenseAdj" else ("idx", "w", "idx_t", "w_t")
        out.update({f"{name}.{f}": np.asarray(getattr(m, f)) for f in fields})
    for f in ("x", "y", "mask", "original_indices"):
        out[f] = np.asarray(getattr(batch, f))
    return out


def _inputs(graph, width=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(graph.num_nodes, width)).astype(np.float32)
    y, classes = next_node_labels(graph)
    return x, y, classes


@pytest.mark.parametrize("fmt", ["dense", "ell"])
@pytest.mark.parametrize("level", [1, 3])
@pytest.mark.parametrize("mapped", [False, True])
def test_cluster_batches_equal_jax(levels, fmt, level, mapped):
    jg, tg = levels
    jt, tt = _trainers(cluster_device_budget_bytes=0,
                       cluster_dense_max_budget=1024 if fmt == "dense" else 0)
    x, y, _ = _inputs(tg[level - 1])
    node_map = None
    if mapped:
        node_map = np.random.default_rng(1).permutation(3 * len(x))[: len(x)]
    jb, j_res = jt._make_cluster_batches(jg[level - 1], x, y, 42, node_map=node_map)
    tb, t_res = tt._make_cluster_batches(tg[level - 1], x, y, 42, node_map=node_map)
    assert j_res is False and t_res is False  # budget 0: every batch host-held
    assert len(tb) == len(jb) >= 2
    assert (type(tb[0].graph.p_in).__name__ == "DenseAdj") == (fmt == "dense")
    for b_t, b_j in zip(tb, jb):
        assert b_t.weight_factor == b_j.weight_factor
        assert b_t.graph.num_nodes == b_j.graph.num_nodes
        a_t, a_j = _arrays(b_t), _arrays(b_j)
        assert sorted(a_t) == sorted(a_j)
        for name in a_j:
            assert a_t[name].dtype == a_j[name].dtype, name
            np.testing.assert_array_equal(a_t[name], a_j[name], err_msg=name)


def test_resident_decision_matches_jax(levels):
    """At a device budget between the ELL and the dense batches' totals
    (60-node clusters: the dense blocks are the larger), the ELL batches
    are resident (tensors on the device, equal to JAX's) and the dense ones
    host-streamed, in both packages."""
    jg, tg = levels
    x, y, _ = _inputs(tg[2])
    totals = {}
    for fmt, cap in (("dense", 1024), ("ell", 0)):
        _, tt = _trainers(cluster_device_budget_bytes=0, cluster_dense_max_budget=cap,
                          target_nodes_per_cluster=60)
        tb, _ = tt._make_cluster_batches(tg[2], x, y, 42)
        totals[fmt] = sum(a.nbytes for b in tb for a in t_trainer._batch_arrays(b))
    assert totals["ell"] < totals["dense"]
    between = (totals["ell"] + totals["dense"]) // 2
    for fmt, cap in (("dense", 1024), ("ell", 0)):
        jt, tt = _trainers(cluster_device_budget_bytes=between, cluster_dense_max_budget=cap,
                           target_nodes_per_cluster=60)
        jb, j_res = jt._make_cluster_batches(jg[2], x, y, 42)
        tb, t_res = tt._make_cluster_batches(tg[2], x, y, 42)
        assert t_res == j_res == (fmt == "ell")
        if t_res:
            assert isinstance(tb[0].x, torch.Tensor) and tb[0].y.dtype == torch.int64
        for b_t, b_j in zip(tb, jb):
            a_t, a_j = _arrays(b_t), _arrays(b_j)
            for name in a_j:
                np.testing.assert_array_equal(a_t[name], a_j[name], err_msg=name)


@pytest.mark.parametrize("n,e", [(1, 0), (5, 0), (7, 3), (60, 400), (500, 4000)])
def test_undirected_matrix_byte_exact_on_raw_edges(n, e):
    """The undirected operator every batch and level builds, on raw edge
    lists with duplicates, both orientations of a pair, self-loops and
    isolated nodes: byte for byte the JAX package's."""
    rng = np.random.default_rng(n + e)
    src = rng.integers(0, n, e).astype(np.int32)
    tgt = rng.integers(0, n, e).astype(np.int32)
    got = t_transforms.undirected_normalized_matrix(src, tgt, n)
    want = j_transforms.undirected_normalized_matrix(src, tgt, n)
    for name in ("indptr", "indices", "data"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def _leaves(tree, path=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [lp for k in sorted(tree) for lp in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [lp for i, v in enumerate(tree) for lp in _leaves(v, path + (i,))]
    return [(path, tree)]


@pytest.mark.parametrize("fmt", ["dense", "ell"])
@pytest.mark.parametrize("constant", ["flat", "rg"])
def test_model_on_a_batch_matches_jax(levels, fmt, constant):
    """One batch of the n = 3 level through both models: the per-node
    gates and constant gathered at the batch's ids of a level of N nodes,
    the constant stored flat [N, out] or rg [A, G, out]."""
    jg, tg = levels
    jt, tt = _trainers(cluster_device_budget_bytes=0,
                       cluster_dense_max_budget=1024 if fmt == "dense" else 0)
    x, y, _ = _inputs(tg[2], width=8)
    jb = jt._make_cluster_batches(jg[2], x, y, 42)[0][1]
    tb = tt._make_cluster_batches(tg[2], x, y, 42)[0][1].to_device("cpu")
    n = tg[2].num_nodes
    dims = (8, 12, 6)
    common = dict(layer_dims=dims, num_nodes=n, num_classes=5, n_gram_len=3,
                  dropout=0.0, decoder_dropout=0.0)
    jcfg, tcfg = j_model.DirectGCNConfig(**common), t_model.DirectGCNConfig(**common)
    jp = j_model.init_directgcn_params(jax.random.PRNGKey(2), jcfg)
    if constant == "rg":
        a = next(d for d in (7, 5, 3, 2, 1) if n % d == 0)
        for lp in jp["layers"]:
            lp["constant"] = lp["constant"].reshape(a, n // a, -1)
    budget = tb.x.shape[0]
    rng = np.random.default_rng(3)
    r_ls = rng.normal(size=(budget, 5)).astype(np.float32)
    r_emb = rng.normal(size=(budget, dims[-1])).astype(np.float32)
    j_dev = jax.tree_util.tree_map(jnp.asarray, jb.graph)

    def j_obj(p):
        ls, emb = j_model.directgcn_apply(p, j_dev, jnp.asarray(jb.x), jcfg, train=True,
                                          rng=jax.random.PRNGKey(0),
                                          original_indices=jnp.asarray(jb.original_indices))
        return jnp.sum(ls * r_ls) + jnp.sum(emb * r_emb), (ls, emb)

    (j_val, (j_ls, j_emb)), j_grads = jax.value_and_grad(j_obj, has_aux=True)(jp)
    tp = convert.params_from_jax(jp, device="cpu")
    for _, t in _leaves(tp):
        t.requires_grad_(True)
    ls, emb = t_model.directgcn_apply(tp, tb.graph, tb.x, tcfg, train=True,
                                      original_indices=tb.original_indices)
    t_val = torch.sum(ls * torch.from_numpy(r_ls)) + torch.sum(emb * torch.from_numpy(r_emb))
    t_val.backward()
    np.testing.assert_allclose(ls.detach().numpy(), np.asarray(j_ls), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(j_emb), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=RTOL)
    j_leaves = dict(_leaves(j_grads))
    assert len(j_leaves) == len(_leaves(tp))
    for path, t in _leaves(tp):
        jg_ = np.asarray(j_leaves[path])
        assert tuple(t.grad.shape) == jg_.shape, path
        np.testing.assert_allclose(t.grad.numpy(), jg_, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(jg_).max())),
                                   err_msg=str(path))


def test_model_without_indices_is_unchanged(levels):
    """``original_indices=None`` is the full-level forward as before."""
    _, tg = levels
    dev = tg[2].to_device(mode="dense", device="cpu")
    cfg = t_model.DirectGCNConfig(layer_dims=(8, 6), num_nodes=dev.num_nodes, num_classes=4,
                                  n_gram_len=3, dropout=0.0, decoder_dropout=0.0)
    p = t_model.init_directgcn_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(dev.num_nodes, 8))
                         .astype(np.float32))
    everyone = torch.arange(dev.num_nodes)
    a = t_model.directgcn_apply(p, dev, x, cfg)
    b = t_model.directgcn_apply(p, dev, x, cfg, original_indices=everyone)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["dense", "ell"])
@pytest.mark.parametrize("level", [1, 3])
def test_three_clustered_epochs_match(levels, monkeypatch, fmt, level):
    jg, tg = levels
    jt, tt = _trainers(cluster_dense_max_budget=1024 if fmt == "dense" else 0)
    for tr in (jt, tt):
        tr.gcn.hidden_layer_dims = [10, 6]
        tr.gcn.one_gram_init_dim = 8
        tr.gcn.epochs_per_level = 3
        tr.gcn.dropout_rate = 0.0
        tr.gcn.use_early_stopping = False
    width = 8 if level == 1 else 6
    x, y, classes = _inputs(tg[level - 1], width=width)

    captured, j_batch_losses, t_batch_losses = {}, [], []
    j_init, j_step, t_step = (j_trainer.init_directgcn_params, j_trainer.make_train_step,
                              t_trainer.make_train_step)

    def capture_init(key, cfg):
        params = j_init(key, cfg)
        captured["params"] = jax.tree_util.tree_map(np.array, params)  # steps donate
        return params

    def capture(make, into, loss_at):
        def factory(*a):
            step = make(*a)

            def wrapped(*args):
                out = step(*args)
                into.append(float(out[loss_at]))
                return out
            return wrapped
        return factory

    monkeypatch.setattr(j_trainer, "init_directgcn_params", capture_init)
    monkeypatch.setattr(j_trainer, "make_train_step", capture(j_step, j_batch_losses, 2))
    monkeypatch.setattr(t_trainer, "make_train_step", capture(t_step, t_batch_losses, 0))
    monkeypatch.setattr(t_trainer, "init_directgcn_params",
                        lambda gen, cfg, device: convert.params_from_jax(captured["params"],
                                                                         device="cpu"))
    for mod, pkg in ((j_trainer, j_model), (t_trainer, t_model)):
        monkeypatch.setattr(mod, "DirectGCNConfig",
                            lambda _cls=pkg.DirectGCNConfig, **kw: _cls(**kw, decoder_dropout=0.0))
    j_params, _, _, _ = jt.train_level(jg[level - 1], x, y, classes)
    t_params, emb, _, _ = tt.train_level(tg[level - 1], x, y, classes)

    st = tt.level_stats[level]
    assert st["route"] == "cluster" and st["block_format"] == fmt and st["resident"]
    assert st["clusters"] >= 2 and st["steps"] == 3 * st["clusters"] == len(j_batch_losses)
    assert emb.shape == (tg[level - 1].num_nodes, 6) and np.isfinite(emb).all()
    np.testing.assert_allclose(t_batch_losses, j_batch_losses, rtol=RTOL)
    per_epoch = np.asarray(j_batch_losses).reshape(3, st["clusters"])
    j_epochs = [sum(float(v) for v in row) / len(row) for row in per_epoch]
    np.testing.assert_allclose(st["losses"], j_epochs, rtol=RTOL)
    drift = ADAM_DRIFT * tt.gcn.lr * st["steps"]
    j_leaves = dict(_leaves(j_params))
    for path, t in _leaves(t_params):
        ref = np.asarray(j_leaves[path]).reshape(tuple(t.shape))
        np.testing.assert_allclose(t.detach().numpy(), ref, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(ref).max())) + drift,
                                   err_msg=str(path))
    assert isinstance(tt._make_cluster_batches(tg[level - 1], x, y, 42)[0][0].graph.p_in,
                      DenseAdj) == (fmt == "dense")
