"""Port parity: DirectGCN forward and gradients.

The JAX package's ``init_directgcn_params`` draws the parameters,
``convert.params_from_jax`` hands the same values to the port, and both
models run on the same inputs (dropout 0, float32) over a dense graph (the
n = 1 level, with the positional table) and a hypercube graph (n = 3, rg
carry).  Tolerance: rtol 1e-4 / atol 1e-5 for the outputs; for each
parameter gradient rtol 1e-4 with atol 1e-5 * max|grad of that leaf|, since a
gradient element is a float32 sum over every node of terms as large as the
leaf's largest element, and cancellation leaves an absolute error that
scales with them, not with the element (three layers of products and
propagations summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder as TBuilder
from protgram_directgcn_torch.models import directgcn as t_model
from protgram_directgcn_tpu.graph.builder import NgramGraphBuilder as JBuilder
from protgram_directgcn_tpu.models import directgcn as j_model

SEQS = [
    ("P1", "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"),
    ("P2", "MKLVTAYIAKQRRQISFVK"),
    ("P3", "GLIEVQAPILSRVGDGTQDNLSGAEKAVQ"),
]
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def graphs():
    return JBuilder(n_max=3).build_from_sequences(SEQS), TBuilder(n_max=3).build_from_sequences(SEQS)


def _case(graphs, kind, dims=(12, 8, 6)):
    """(jax graph, port graph, jax cfg, port cfg, x) for a dense n=1 or a
    hypercube n=3 level."""
    jg, tg = graphs
    if kind == "dense":
        j_dev = jg[0].to_device(mode="dense")
        t_dev = tg[0].to_device(mode="dense", device="cpu")
        n_gram, one_gram = 1, dims[0]
    else:
        j_dev = jg[2].to_device(mode="hypercube")
        t_dev = tg[2].to_device(mode="hypercube", device="cpu")
        n_gram, one_gram = 3, 0
    n = t_dev.num_nodes
    common = dict(layer_dims=dims, num_nodes=n, num_classes=5, n_gram_len=n_gram,
                  one_gram_dim=one_gram, max_pe_len=16, dropout=0.0, decoder_dropout=0.0)
    x = np.random.default_rng(7).normal(size=(n, dims[0])).astype(np.float32)
    return j_dev, t_dev, j_model.DirectGCNConfig(**common), t_model.DirectGCNConfig(**common), x


def _leaves_with_paths(tree, path=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [lp for k in sorted(tree) for lp in _leaves_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [lp for i, v in enumerate(tree) for lp in _leaves_with_paths(v, path + (i,))]
    return [(path, tree)]


@pytest.mark.parametrize("kind", ["dense", "hypercube"])
def test_forward_matches(graphs, kind):
    j_dev, t_dev, jcfg, tcfg, x = _case(graphs, kind)
    jp = j_model.init_directgcn_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jp, device="cpu")
    j_ls, j_emb = j_model.directgcn_apply(jp, j_dev, jnp.asarray(x), jcfg, train=False)
    t_ls, t_emb = t_model.directgcn_apply(tp, t_dev, torch.from_numpy(x), tcfg, train=False)
    assert t_ls.shape == j_ls.shape and t_emb.shape == j_emb.shape
    np.testing.assert_allclose(t_ls.numpy(), np.asarray(j_ls), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["dense", "hypercube"])
def test_gradients_match(graphs, kind):
    j_dev, t_dev, jcfg, tcfg, x = _case(graphs, kind)
    jp = j_model.init_directgcn_params(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(3)
    r_ls = rng.normal(size=(t_dev.num_nodes, 5)).astype(np.float32)
    r_emb = rng.normal(size=(t_dev.num_nodes, 6)).astype(np.float32)

    def j_obj(p):
        ls, emb = j_model.directgcn_apply(p, j_dev, jnp.asarray(x), jcfg, train=True,
                                          rng=jax.random.PRNGKey(5))
        return jnp.sum(ls * r_ls) + jnp.sum(emb * r_emb)

    j_val, j_grads = jax.value_and_grad(j_obj)(jp)
    tp = convert.params_from_jax(jp, device="cpu")
    leaves = [t for _, t in _leaves_with_paths(tp)]
    for t in leaves:
        t.requires_grad_(True)
    ls, emb = t_model.directgcn_apply(tp, t_dev, torch.from_numpy(x), tcfg, train=True,
                                      gen=torch.Generator().manual_seed(5))
    t_val = torch.sum(ls * torch.from_numpy(r_ls)) + torch.sum(emb * torch.from_numpy(r_emb))
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=RTOL)
    j_leaves = dict(_leaves_with_paths(j_grads))
    t_leaves = _leaves_with_paths(tp)
    assert len(t_leaves) == len(j_leaves)
    for path, t in t_leaves:
        jg = np.asarray(j_leaves[path]).reshape(tuple(t.shape))
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(jg).max())),
                                   err_msg=str(path))


@pytest.mark.parametrize("dims", [(12, 8, 6), (6, 6), (10, 16, 16, 4)])
def test_init_tree_matches_jax(graphs, dims):
    _, t_dev, jcfg, tcfg, _ = _case(graphs, "dense", dims)
    jp = j_model.init_directgcn_params(jax.random.PRNGKey(0), jcfg)
    tp = t_model.init_directgcn_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    j_leaves = _leaves_with_paths(jp)
    t_leaves = _leaves_with_paths(tp)
    assert [p for p, _ in t_leaves] == [p for p, _ in j_leaves]
    for (_, t), (_, j) in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == tuple(j.shape)
        assert t.dtype == torch.float32
    assert len(t_model.param_leaves(tp)) == len(j_leaves)


def test_rg_input_equals_flat_input(graphs):
    _, t_dev, _, tcfg, x = _case(graphs, "hypercube")
    tp = t_model.init_directgcn_params(torch.Generator().manual_seed(2), tcfg, device="cpu")
    a, g = t_dev.p_in.feature_shape
    flat = t_model.directgcn_apply(tp, t_dev, torch.from_numpy(x), tcfg)
    rg = t_model.directgcn_apply(tp, t_dev, torch.from_numpy(x).reshape(a, g, -1), tcfg)
    for f_out, rg_out in zip(flat, rg):
        torch.testing.assert_close(f_out, rg_out, rtol=0, atol=0)
    ls, _ = t_model.directgcn_apply(tp, t_dev, torch.from_numpy(x), tcfg, flatten_rg=False)
    assert ls.shape == (a, g, 5)
