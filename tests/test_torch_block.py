"""Port parity: the block n-gram format (``ops/block.py``).

The same seeded inputs through the JAX package and the port on the CPU:

- ``ngram_node_keys`` and ``build_block_ngram``'s factors field for field,
  byte for byte, on the three propagation matrices of real n = 2, 3 and 4
  levels, and the same ``BlockStructureError`` where the structure breaks
  or a group passes ``max_block``; ``block_gather_rows``;
- ``propagate`` forward and its x-gradient against the JAX package's (its
  custom VJP applies the transposed factors), rtol 1e-5, atol 1e-6 (float32
  sums in another order), and against the dense product of the same
  matrix;
- the format ``build_adjacency(mode="auto")`` and ``NgramGraph.to_device``
  pick, against the JAX package's, and a level trained on block operators
  through ``train_level`` (the fallback off the hypercube) against the
  same three steps of the JAX trainer (losses rtol 1e-4).
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
from protgram_directgcn_torch.ops import block as t_block
from protgram_directgcn_torch.ops import hypercube as t_hyper
from protgram_directgcn_torch.ops import spmm as t_spmm
from protgram_directgcn_torch.pipeline import trainer as t_trainer
from protgram_directgcn_torch.utils.io import parse_fasta
from protgram_directgcn_tpu.config import Config as JConfig
from protgram_directgcn_tpu.graph.builder import NgramGraphBuilder as JBuilder
from protgram_directgcn_tpu.models import directgcn as j_model
from protgram_directgcn_tpu.ops import block as j_block
from protgram_directgcn_tpu.ops import hypercube as j_hyper
from protgram_directgcn_tpu.ops import spmm as j_spmm
from protgram_directgcn_tpu.pipeline import trainer as j_trainer
from tests.test_torch_graph import write_seeded_fasta

MATRICES = ("mathcal_a_in", "mathcal_a_out", "undirected_norm")
FIELDS = ("d", "wf", "wb", "sgrp", "pgrp", "pos_p", "pos_s")


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    fasta = write_seeded_fasta(tmp_path_factory.mktemp("block") / "seq.fasta", n_seqs=80,
                               lo=40, hi=120)
    seqs = list(parse_fasta(fasta))
    return JBuilder(n_max=4).build_from_sequences(seqs), TBuilder(n_max=4).build_from_sequences(seqs)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _factors(g, matrix, keys):
    src, tgt, val = t_transforms.csr_to_coo_arrays(getattr(g, matrix)())
    return (src, tgt, val, g.num_nodes) + tuple(keys)


@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("level", [2, 3, 4])
def test_factors_match_jax(graphs, level, matrix):
    jg, tg = graphs
    keys = t_block.ngram_node_keys(tg[level - 1].vocab)
    for a, b in zip(keys, j_block.ngram_node_keys(jg[level - 1].vocab)):
        _same(a, b)
    args = _factors(tg[level - 1], matrix, keys)
    t = t_block.build_block_ngram(*args, device="cpu")
    j = j_block.build_block_ngram(*args)
    for field in FIELDS:
        _same(getattr(t, field).numpy(), getattr(j, field))
    assert t.n_out == j.n_out == tg[level - 1].num_nodes
    assert t_block.block_gather_rows(t) == j_block.block_gather_rows(j)


def test_structure_errors_match_jax(graphs):
    _, tg = graphs
    keys = t_block.ngram_node_keys(tg[2].vocab)
    args = _factors(tg[2], "mathcal_a_in", keys)
    for build in (lambda: t_block.build_block_ngram(*args, max_block=4, device="cpu"),
                  lambda: j_block.build_block_ngram(*args, max_block=4)):
        with pytest.raises(ValueError, match="exceed max_block=4"):
            build()
    assert issubclass(t_block.BankBudgetError, t_block.BlockStructureError)
    assert t_hyper.BlockStructureError is t_block.BlockStructureError


@pytest.mark.parametrize("level", [2, 3, 4])
@pytest.mark.parametrize("f", [1, 16])
def test_propagation_matches_jax_and_dense(graphs, level, f):
    jg, tg = graphs
    g = tg[level - 1]
    keys = t_block.ngram_node_keys(g.vocab)
    rng = np.random.default_rng(level * 10 + f)
    for matrix in MATRICES:
        args = _factors(g, matrix, keys)
        t = t_block.build_block_ngram(*args, device="cpu")
        j = j_block.build_block_ngram(*args)
        x = rng.normal(size=(g.num_nodes, f)).astype(np.float32)
        cot = rng.normal(size=(g.num_nodes, f)).astype(np.float32)
        y_j, vjp = jax.vjp(lambda v: j_spmm.propagate(j, v), jnp.asarray(x))
        (dx_j,) = vjp(jnp.asarray(cot))
        xt = torch.from_numpy(x).requires_grad_(True)
        y_t = t_spmm.propagate(t, xt)
        y_t.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-5, atol=1e-6)
        # Neither package's propagate_transpose takes a block operator.
        with pytest.raises(TypeError):
            t_spmm.propagate_transpose(t, torch.from_numpy(cot))
        dense = getattr(g, matrix)().toarray().astype(np.float64)
        # The matrix's (row -> col) entries aggregate at col: out = Mᵀ x.
        np.testing.assert_allclose(y_t.detach().numpy(), dense.T @ x, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("feat_dim", [4, 64, 256])
@pytest.mark.parametrize("level", [2, 3, 4])
def test_format_choice_matches_jax(graphs, level, feat_dim):
    jg, tg = graphs
    j = jg[level - 1].to_device(mode="auto", feat_dim=feat_dim)
    t = tg[level - 1].to_device(mode="auto", feat_dim=feat_dim, device="cpu")
    for name in ("p_in", "p_out", "p_und"):
        assert type(getattr(t, name)).__name__ == type(getattr(j, name)).__name__
        if isinstance(getattr(j, name), j_block.BlockNgramAdj):
            for field in FIELDS:
                _same(getattr(getattr(t, name), field).numpy(), getattr(getattr(j, name), field))


def test_block_level_trains_like_jax(graphs, monkeypatch):
    """The n = 3 level with the hypercube build made to fail: both trainers
    fall back to ``to_device(mode="auto")``, which takes the block format at
    the input width 4 (tests/test_torch_trainer.py), and train three steps
    from the same parameters, float32, dropout 0."""
    jg, tg = graphs

    def fail_t(*a, **k):
        raise t_block.BlockStructureError("forced")

    def fail_j(*a, **k):
        raise j_block.BlockStructureError("forced")

    monkeypatch.setattr(t_hyper, "build_hypercube", fail_t)
    monkeypatch.setattr(j_hyper, "build_hypercube", fail_j)
    captured, j_losses = {}, []
    j_init, j_step = j_trainer.init_directgcn_params, j_trainer.make_train_step

    def capture_init(key, cfg):
        params = j_init(key, cfg)
        captured["params"] = jax.tree_util.tree_map(np.array, params)
        return params

    def capture_step(cfg, opt, l2):
        step = j_step(cfg, opt, l2)

        def wrapped(*args):
            out = step(*args)
            j_losses.append(float(out[2]))
            return out
        return wrapped

    monkeypatch.setattr(j_trainer, "init_directgcn_params", capture_init)
    monkeypatch.setattr(j_trainer, "make_train_step", capture_step)
    monkeypatch.setattr(t_trainer, "init_directgcn_params",
                        lambda gen, cfg, device: convert.params_from_jax(captured["params"],
                                                                         device="cpu"))
    for mod, pkg in ((j_trainer, j_model), (t_trainer, t_model)):
        monkeypatch.setattr(mod, "DirectGCNConfig",
                            lambda _cls=pkg.DirectGCNConfig, **kw: _cls(**kw, decoder_dropout=0.0))
    rng = np.random.default_rng(2)
    n = tg[2].num_nodes
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = rng.integers(0, 5, n).astype(np.int64)
    trainers = []
    for tr in (j_trainer.HierarchicalTrainer(JConfig()),
               t_trainer.HierarchicalTrainer(TConfig(), device="cpu")):
        tr.gcn.hidden_layer_dims = [4]
        tr.gcn.epochs_per_level = 3
        tr.gcn.dropout_rate = 0.0
        tr.gcn.use_early_stopping = False
        trainers.append(tr)
    *_, j_dev = trainers[0].train_level(jg[2], x, y, 5)
    _, emb, _, t_dev = trainers[1].train_level(tg[2], x, y, 5)
    assert isinstance(j_dev.p_in, j_block.BlockNgramAdj) and t_dev.route == "block"
    st = trainers[1].level_stats[3]
    np.testing.assert_allclose(st["losses"], j_losses, rtol=1e-4)
    assert emb.shape == (n, 4) and np.isfinite(emb).all()
