"""Port parity: the GNN zoo (``models/zoo.py``) against the JAX package's.

Every model, one parametrised test a check, on three graphs:
- KarateClub (34 nodes; every operator dense on both sides),
- a seeded 300-node ring whose operators are ELL on both sides,
- the ring with a hub node joined both ways to every node, whose operators
  are bucketed ELL on both sides (degree skew).
The formats are asserted on both sides.  The JAX parameters are injected
(``convert.zoo_params_from_jax``).  Checked, at narrow widths:
- the host operator arrays, byte-equal to the JAX builders';
- eval-mode logits and embeddings: rtol 1e-5, atol 1e-5 * max|output|;
- the gradients of the masked cross-entropy (train mode, no dropout):
  rtol 1e-4, atol 1e-5 * max|gradient| (float32 sums in other orders);
- three ``train_and_evaluate`` epochs of each package's benchmarker with
  dropout 0 (the models built from a monkeypatched ``_zoo_configs``):
  losses epoch by epoch at rtol 1e-5, accuracies, ``best_val`` and
  ``best_test`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.bench import datasets as t_data
from protgram_directgcn_torch.bench import gnn_benchmarker as t_bench
from protgram_directgcn_torch.models import zoo as t_zoo
from protgram_directgcn_torch.models.directgcn import param_leaves
from protgram_directgcn_tpu.bench import datasets as j_data
from protgram_directgcn_tpu.bench import gnn_benchmarker as j_bench
from protgram_directgcn_tpu.config import Config as JConfig
from protgram_directgcn_tpu.models import zoo as j_zoo

MODELS = ["GCN", "GAT", "GraphSAGE", "GIN", "ChebNet", "RGCN", "TongDiGCN"]
GRAPHS = {"karate": "DenseAdj", "ring": "EllAdj", "hub": "BucketedEllAdj"}
HIDDEN = 16


def _small_configs(zoo):
    """Each model at narrow widths with dropout 0 (the benchmarker's
    ``_zoo_configs`` shape, keyed by the zoo's class names)."""
    return {
        "GCN": dict(cls=zoo["GCN"], params=dict(hidden_dim=HIDDEN, num_layers=2, dropout_rate=0.0)),
        "GAT": dict(cls=zoo["GAT"], params=dict(hidden_dim=8, heads=2, num_layers=2,
                                                dropout_rate=0.0)),
        "GraphSAGE": dict(cls=zoo["GraphSAGE"], params=dict(hidden_dim=HIDDEN, num_layers=2,
                                                            dropout_rate=0.0)),
        "GIN": dict(cls=zoo["GIN"], params=dict(hidden_dim=HIDDEN, num_layers=2, dropout_rate=0.0)),
        "ChebNet": dict(cls=zoo["ChebNet"], params=dict(hidden_dim=HIDDEN, K=3, num_layers=2,
                                                        dropout_rate=0.0)),
        "RGCN": dict(cls=zoo["RGCN"], params=dict(hidden_dim=HIDDEN, num_relations=1,
                                                  num_layers=2, dropout_rate=0.0)),
        "TongDiGCN": dict(cls=zoo["TongDiGCN"], params=dict(hidden_dim=HIDDEN, num_layers=2,
                                                            dropout_rate=0.0)),
    }


def _graph_case(kind):
    """(JAX dataset, port dataset) of one graph, from numpy seeds."""
    if kind == "karate":
        j = j_data.karate_club()
        return j, t_data.karate_club()
    n, c, f = 300, 5, 24
    rng = np.random.default_rng(11)
    src = np.repeat(np.arange(n), 3)
    tgt = (src + np.tile([1, 2, 3], n)) % n
    if kind == "hub":
        others = np.arange(1, n)
        src = np.concatenate([src, others, np.zeros(n - 1, np.int64)])
        tgt = np.concatenate([tgt, np.zeros(n - 1, np.int64), others])
    edges = np.unique(np.stack([src, tgt], 1), axis=0).T.astype(np.int64)
    x = (rng.random((n, f)) < 0.2).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int64)
    fields = dict(name=kind, x=x, edge_index=edges, y=y)
    return j_data.NodeClassificationDataset(**fields), t_data.NodeClassificationDataset(**fields)


@pytest.fixture(scope="module")
def cases():
    return {kind: _graph_case(kind) for kind in GRAPHS}


def _models(name, jds, tds):
    jspec = _small_configs(j_zoo.ZOO_MODELS)[name]
    tspec = _small_configs(t_zoo.ZOO_MODELS)[name]
    common = dict(edge_index=jds.edge_index, num_nodes=jds.num_nodes, in_dim=jds.x.shape[1],
                  out_dim=jds.num_classes)
    jm = jspec["cls"](**common, **jspec["params"])
    tm = tspec["cls"](**common, **tspec["params"], device="cpu")
    return jm, tm


def _operators(model):
    if hasattr(model, "fwd"):
        return [model.fwd.adj, model.bwd.adj]
    return [getattr(model, a) for a in ("adj", "lap") if hasattr(model, a)]


def _pairs(j, t, path=()):
    if isinstance(j, dict):
        assert set(j) == set(t), path
        return [p for k in sorted(j) for p in _pairs(j[k], t[k], path + (k,))]
    if isinstance(j, (list, tuple)):
        assert len(j) == len(t), path
        return [p for i, (a, b) in enumerate(zip(j, t)) for p in _pairs(a, b, path + (i,))]
    return [(path, np.asarray(j), t)]


def _adj_arrays(adj):
    """The operator's arrays by field name, as numpy."""
    fields = [f for f in vars(adj) if not f.startswith("_")]
    out = {}
    for f in fields:
        v = getattr(adj, f)
        if isinstance(v, (tuple, list)):
            for i, e in enumerate(v):
                out[f"{f}[{i}]"] = np.asarray(e.cpu() if isinstance(e, torch.Tensor) else e)
        elif isinstance(v, torch.Tensor):
            out[f] = v.cpu().numpy()
        elif hasattr(v, "shape"):
            out[f] = np.asarray(v)
    return out


def _masked_ce(logits_log_softmax, y, mask):
    per = -logits_log_softmax[np.arange(len(y)), y]
    return (per * mask).sum() / mask.sum()


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("name", MODELS)
def test_operators_and_formats_match_jax(cases, name, graph):
    jds, tds = cases[graph]
    jm, tm = _models(name, jds, tds)
    j_ops, t_ops = _operators(jm), _operators(tm)
    assert len(j_ops) == len(t_ops)
    for ja, ta in zip(j_ops, t_ops):
        assert type(ja).__name__ == type(ta).__name__ == GRAPHS[graph]
        jarr, tarr = _adj_arrays(ja), _adj_arrays(ta)
        assert set(jarr) == set(tarr)
        for key in jarr:
            np.testing.assert_array_equal(tarr[key].astype(jarr[key].dtype), jarr[key],
                                          err_msg=key)
    if name == "GAT":
        np.testing.assert_array_equal(tm.src.numpy(), np.asarray(jm.src))
        np.testing.assert_array_equal(tm.tgt.numpy(), np.asarray(jm.tgt))


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("name", MODELS)
def test_forward_and_gradients_match_jax(cases, name, graph):
    jds, tds = cases[graph]
    jm, tm = _models(name, jds, tds)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tp = convert.zoo_params_from_jax(name, jp, device="cpu")
    x = jnp.asarray(jds.x)
    xt = torch.from_numpy(tds.x)
    j_logits, j_emb = jax.jit(lambda p: jm.apply(p, x, False, None))(jp)
    with torch.no_grad():
        t_logits, t_emb = tm.apply(tp, xt, False, None)
    for got, want in ((t_logits, j_logits), (t_emb, j_emb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

    y = jds.y
    mask = (np.random.default_rng(5).random(len(y)) < 0.5).astype(np.float32)

    def j_loss(p):
        logits, _ = jm.apply(p, x, True, None)
        return _masked_ce(jax.nn.log_softmax(logits, axis=-1), jnp.asarray(y), jnp.asarray(mask))

    j_value, j_grads = jax.jit(jax.value_and_grad(j_loss))(jp)
    leaves = [t for _, _, t in _pairs(jp, tp)]
    for t in leaves:
        t.requires_grad_(True)
    logits, _ = tm.apply(tp, xt, True, None)
    t_loss = _masked_ce(torch.log_softmax(logits, -1), torch.from_numpy(y), torch.from_numpy(mask))
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_value), rtol=1e-5)
    for path, jg, t in _pairs(j_grads, tp):
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(jg).max(), 1e-30), err_msg=str(path))


@pytest.mark.parametrize("graph", ["karate", "ring"])
@pytest.mark.parametrize("name", MODELS)
def test_three_epochs_match_jax(monkeypatch, cases, name, graph):
    jds, tds = cases[graph]
    monkeypatch.setattr(j_bench.GNNBenchmarker, "_zoo_configs",
                        lambda self: _small_configs(j_zoo.ZOO_MODELS))
    monkeypatch.setattr(t_bench.GNNBenchmarker, "_zoo_configs",
                        lambda self: _small_configs(t_zoo.ZOO_MODELS))
    jb = j_bench.GNNBenchmarker(JConfig())
    tb = t_bench.GNNBenchmarker(device="cpu")
    jspec, tspec = jb._zoo_configs()[name], tb._zoo_configs()[name]
    common = dict(edge_index=jds.edge_index, num_nodes=jds.num_nodes, in_dim=jds.x.shape[1],
                  out_dim=jds.num_classes)
    jm = jspec["cls"](**common, **jspec["params"])
    tm = tspec["cls"](**common, **tspec["params"], device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(9))
    tp = convert.zoo_params_from_jax(name, jp, device="cpu")
    masks = j_bench.seeded_split(jds.num_nodes, jb.bench.split_ratios, 4)
    jv, jt, jh, _ = jb.train_and_evaluate(name, jm.apply, jp, jds, masks, epochs=3, lr=1e-2,
                                          wd=5e-4, seed=4, graph=jm.graph_arrays())
    tv, tt, th, tbest = tb.train_and_evaluate(name, tm.apply, tp, tds, masks, epochs=3, lr=1e-2,
                                              wd=5e-4, seed=4)
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=1e-5)
    assert [h["val_accuracy"] for h in th] == [h["val_accuracy"] for h in jh]
    assert [h["epoch"] for h in th] == [0, 1, 2]
    assert (tv, tt) == (jv, jt)
    # The best parameters are a copy, not the leaves the optimizer stepped.
    for p, b in zip(param_leaves(tp), param_leaves(tbest)):
        assert b is not p and not b.requires_grad


def test_zoo_params_from_jax_checks_the_tree():
    with pytest.raises(KeyError, match="GCN layer 0"):
        convert.zoo_params_from_jax("GCN", {"layers": [{"w": np.ones((2, 2))}]}, device="cpu")
    with pytest.raises(KeyError, match="unknown zoo model"):
        convert.zoo_params_from_jax("MLP", {"layers": []}, device="cpu")


@pytest.mark.parametrize("name", MODELS)
def test_own_init_shapes_and_dropout(cases, name):
    """The port's own init has the JAX trees' shapes (GAT's attention
    vectors [1, H, D] with fan_in H), and dropout draws from the generator:
    the same seed, the same training output."""
    jds, tds = cases["ring"]
    jm, tm = _models(name, jds, tds)
    spec = {**_small_configs(t_zoo.ZOO_MODELS)[name]["params"], "dropout_rate": 0.5}
    tm = t_zoo.ZOO_MODELS[name](edge_index=tds.edge_index, num_nodes=tds.num_nodes,
                                in_dim=tds.x.shape[1], out_dim=tds.num_classes, device="cpu",
                                **spec)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tm.init_params(torch.Generator().manual_seed(0))
    for path, j, t in _pairs(jp, tp):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, path
        if path[-1] in ("att_src", "att_dst"):
            limit = (6.0 / (j.shape[-2] + j.shape[-1])) ** 0.5
            assert float(t.abs().max()) <= limit
    x = torch.from_numpy(tds.x)
    outs = [tm.apply(tp, x, True, torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
