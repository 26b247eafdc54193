"""Port parity: memory tier 4 (the layer-staged step), the oversize
policies and the literal ``fused=False`` layer.

Held against the JAX package on the CPU, on inputs made with numpy from a
seed:

- three staged steps (``make_train_step_staged``, a stage per layer) against
  three of the port's fused step and three of the JAX package's staged step
  from the same parameters, float32, dropout 0, on dense, ELL and rg
  hypercube levels (the hypercube with and without per-path remat and the
  packed carry; a net whose 24-wide carry is recomputed from the stage below
  and not kept): losses and parameters at the three-step parity tolerance,
  rtol 1e-4 and atol 1e-5 * max|leaf| (float32 updates of gradients summed
  in another order); the staged step against the port's fused step at the
  same tolerance;
- the plan: with both byte models replaced by one cost of the levers, the
  staged step and the dims, the tier, the split, the degraded dims and the
  error (with its mesh size) equal the JAX package's at every budget, away
  from a tier boundary; the Swiss-Prot 5-gram level at the default dims
  under each package's own byte model;
- ``train_level`` at tier 4 against the same level at tier 3 (losses rtol
  1e-4), and at the dims the degrade policy names;
- the literal layer's outputs and gradients against the JAX package's at
  the tolerance of tests/test_torch_model.py (rtol 1e-5, atol 1e-5 *
  max|leaf|).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protgram_directgcn_torch import convert
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
from tests.test_torch_tiers import _lever_cost, _stub

STEP_RTOL, STEP_ATOL_REL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    fasta = write_seeded_fasta(tmp_path_factory.mktemp("staged") / "seq.fasta", n_seqs=60,
                               lo=30, hi=90)
    seqs = list(parse_fasta(fasta))
    return JBuilder(n_max=2).build_from_sequences(seqs), TBuilder(n_max=2).build_from_sequences(seqs)


def _leaves(tree, path=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [lp for k in sorted(tree) for lp in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [lp for i, v in enumerate(tree) for lp in _leaves(v, path + (i,))]
    return [(path, tree)]


def _close(t_tree, j_tree, what):
    j_leaves = dict(_leaves(j_tree))
    for path, t in _leaves(t_tree):
        j = np.asarray(j_leaves[path], np.float32).reshape(tuple(t.shape))
        np.testing.assert_allclose(t.detach().float().numpy(), j, rtol=STEP_RTOL,
                                   atol=STEP_ATOL_REL * max(1.0, float(np.abs(j).max())),
                                   err_msg=str((what, path)))


# (format, dims, remat, remat_paths, l2_lambda, weight decay): L2 in the
# gradient everywhere, and weight decay in the optimizer on two of them.
STEP_CASES = [
    ("dense", (10, 16, 8), False, False, 1e-3, 0.0),
    ("dense", (10, 16, 8), False, False, 0.0, 1e-2),
    ("ell", (10, 16, 8), True, False, 1e-3, 0.0),
    ("hypercube", (10, 16, 8), True, False, 1e-3, 0.0),
    ("hypercube", (10, 32, 16), True, True, 1e-3, 0.0),  # per-path remat, packed carries
    ("hypercube", (10, 32, 16), True, True, 0.0, 1e-2),
    ("hypercube", (10, 24, 16, 8), True, True, 1e-3, 0.0),  # a 24-wide carry is recomputed
]


@pytest.mark.parametrize("kind,dims,remat,remat_paths,l2_lambda,wd", STEP_CASES)
def test_three_staged_steps_match_fused_and_jax(monkeypatch, graphs, kind, dims, remat,
                                                remat_paths, l2_lambda, wd):
    """The n = 2 level; "ell" runs the port's ELL operators through the
    kernels' entry points (``spmm._on_card`` made true)."""
    jg, tg = graphs
    if kind == "ell":
        monkeypatch.setattr(t_spmm, "_on_card", lambda t: True)
    j_dev = jg[1].to_device(mode=kind)
    t_dev = tg[1].to_device(mode=kind, device="cpu")
    n, real = t_dev.num_nodes, tg[1].num_nodes
    common = dict(layer_dims=dims, num_nodes=n, num_classes=real, n_gram_len=2, dropout=0.0,
                  decoder_dropout=0.0, remat=remat, remat_paths=remat_paths)
    jcfg = j_model.DirectGCNConfig(**common)
    tcfg = t_model.DirectGCNConfig(**common)
    rng = np.random.default_rng(len(dims))
    x = rng.normal(size=(n, dims[0])).astype(np.float32)
    y = np.zeros(n, np.int64)
    mask = np.zeros(n, np.float32)
    node_map = np.arange(real) if t_dev.node_map is None else t_dev.node_map.numpy()
    y[node_map] = next_node_labels(tg[1])[0]
    mask[node_map] = 1.0
    jx = jnp.asarray(x)
    if kind == "hypercube":  # rg inputs and rg constants, as both trainers train them
        lead = t_dev.p_in.feature_shape
        x = x.reshape(lead + (dims[0],))
        jx = jx.reshape(lead + (dims[0],))

    jp = j_model.init_directgcn_params(jax.random.PRNGKey(2), jcfg)
    if kind == "hypercube":
        jp = j_trainer._node_params_to_rg(jp, j_dev)
    factor = n if remat_paths else None
    j_step = j_trainer.make_train_step_staged(
        jcfg, lambda: j_trainer.make_optimizer(1e-2, wd, factor_node_params_above=factor),
        l2_lambda, list(range(1, len(dims))))
    j_state = j_step.init_opt_state(jp)

    ports = {}
    for staged in (False, True):
        tp = convert.params_from_jax(jp, device="cpu")
        for p in t_model.param_leaves(tp):
            p.requires_grad_(True)
        opt = t_trainer.make_optimizer(tp, 1e-2, wd, factor_node_params_above=factor)
        make = t_trainer.make_train_step_staged if staged else t_trainer.make_train_step
        ports[staged] = (tp, make(tcfg, opt, l2_lambda), [])
    xt, yt, mt = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    for _ in range(3):
        jp, j_state, j_loss, j_primary = j_step(
            jp, j_state, j_dev, jx, jnp.asarray(y, jnp.int32), jnp.asarray(mask),
            jnp.float32(1.0), jax.random.PRNGKey(0), None)
        for staged, (tp, step, losses) in ports.items():
            loss, primary = step(tp, t_dev, xt, yt, mt, 1.0, None)
            losses.append(float(loss))
            np.testing.assert_allclose(float(loss), float(j_loss), rtol=STEP_RTOL)
            np.testing.assert_allclose(float(primary), float(j_primary), rtol=STEP_RTOL)
    _close(ports[True][0], jp, "staged vs JAX staged")
    _close(ports[True][0], convert.params_to_numpy(ports[False][0]), "staged vs fused")
    np.testing.assert_allclose(ports[True][2], ports[False][2], rtol=STEP_RTOL)


def test_staged_step_refuses_a_positional_table_and_subgraph_batches(graphs):
    _, tg = graphs
    cfg = t_model.DirectGCNConfig(layer_dims=(8, 4), num_nodes=4, num_classes=2, n_gram_len=1,
                                  one_gram_dim=8)
    with pytest.raises(ValueError, match="positional"):
        t_trainer.make_train_step_staged(cfg, None, 0.0)
    cfg = t_model.DirectGCNConfig(layer_dims=(8, 4), num_nodes=4, num_classes=2, n_gram_len=2)
    step = t_trainer.make_train_step_staged(cfg, None, 0.0)
    with pytest.raises(ValueError, match="subgraph"):
        step(None, None, None, None, None, 1.0, None, original_indices=torch.zeros(2))


# -----------------------------------------------------------------------------
# The plan
# -----------------------------------------------------------------------------


def _shared_cost(cd, nd, rm, fc, staged, dims, shards):
    """GiB: the lever cost of tests/test_torch_tiers.py, 3 more unstaged,
    scaled by the dims' sum against [256, 128, 64] and divided by the node
    shards: tiers 0-4 cost 27, 19, 13, 9 and 6 at the configured dims."""
    dims = [256, 128, 64] if dims is None else list(dims)
    base = _lever_cost(cd, nd, rm, fc) + (0 if staged else 3)
    return int(base * sum(dims) / 448 * 2**30) // max(1, shards)


def _shared_plans(monkeypatch, gib, policy="degrade"):
    jt = j_trainer.HierarchicalTrainer(JConfig())
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    for tr in (jt, tt):
        tr.gcn.oversize_policy = policy
        tr._hbm_override = int(gib * 2**30)
    monkeypatch.setattr(jt, "_residency", lambda n, feat, cd, nd, rm, fc, remat_paths=False,
                        staged=False, out_dims=None, shards=1: (
                            0, 0, _shared_cost(cd, nd, rm, fc, staged, out_dims, shards)))
    monkeypatch.setattr(tt, "_residency", lambda n, feat, classes, cd, nd, rm, fc, rp,
                        staged=False, out_dims=None, shards=1: (
                            0, 0, _shared_cost(cd, nd, rm, fc, staged, out_dims, shards)))
    out = []
    for plan in (lambda: jt._level_plan(_stub(5), feat_dim=64),
                 lambda: tt._level_plan(_stub(5), 64, num_classes=4)):
        try:
            out.append(plan())
        except ValueError as exc:
            out.append(exc)
    return out


# (budget GiB, policy, port tier or None where both raise, degraded dims)
PLAN_CASES = [
    (40, "degrade", 0, None),
    (20, "degrade", 2, None),
    (10.5, "degrade", 4, None),  # tier 3 needs 12 with the slack and bank floor
    (8, "degrade", 3, (128, 64, 32)),  # degraded dims fit a cheaper tier again
    (5, "degrade", 4, (64, 32, 16)),
    (3.5, "degrade", None, None),  # no dims fit
    (8, "error", None, None),
]


@pytest.mark.parametrize("gib,policy,tier,dims", PLAN_CASES)
def test_plan_tier4_degrade_and_error_match_jax(monkeypatch, gib, policy, tier, dims):
    jplan, tplan = _shared_plans(monkeypatch, gib, policy)
    if tier is None:
        assert isinstance(jplan, ValueError) and isinstance(tplan, ValueError)
        for exc in (jplan, tplan):
            assert str(exc).startswith("level n=5: gcn.hidden_layer_dims=[256, 128, 64] does "
                                       f"not fit {gib:.1f} GB at any memory tier")
        need = str(jplan).split("parallel.mesh_nodes>=")[1].split()[0]
        assert f"parallel.mesh_nodes>={need} " in str(tplan)
        # The dims that would fit (error policy), or none.
        fix = str(jplan).split("gcn.hidden_layer_dims=")[-1].split(" (")[0]
        assert (fix == "[128, 64, 32]") == (policy == "error")
        assert str(tplan).split("gcn.hidden_layer_dims=")[-1].split(" (")[0] == fix
        return
    assert tplan.tier == tier
    for field in ("compute_dtype", "node_param_dtype", "remat", "remat_paths", "factored",
                  "stage_split", "layer_dims_override"):
        assert getattr(tplan, field) == getattr(jplan, field), field
    assert tplan.layer_dims_override == dims
    assert (tplan.stage_split > 0) == (tier == 4)


def test_swissprot_five_gram_level_plans_tier_4_on_one_card():
    """Swiss-Prot's 5-gram level: 26 letters (25 and the space), 26^5 =
    11,881,376 hypercube nodes, the default dims [256, 128, 64] on input
    width 64, 4 classes, under each package's own byte model at the 79 GiB
    one H100 leaves.  The port fits no tier up to 3 there (tier 3 needs
    83.6 GB), and tier 4 fits: it trains the configured dims."""
    chars = list("ABCDEFGHIKLMNPQRSTUVWXYZO ")
    assert len(chars) == 26
    graph = _stub(5, num_nodes=11_881_376 // 2)
    graph.vocab = np.array(["".join(chars[(i + j) % 26] for j in range(5)) for i in range(26)])
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    tt._hbm_override = 79 << 30
    plan = tt._level_plan(graph, 64, num_classes=4)
    assert (plan.tier, plan.layer_dims_override) == (4, None)
    n = 26**5
    tier3 = sum(tt._residency(n, 64, 4, *t_trainer.TIER_LEVERS[3]))
    assert tier3 + tt._PLAN_SLACK + tt._MIN_BANK > 79 << 30


# -----------------------------------------------------------------------------
# train_level at tier 4 and degraded
# -----------------------------------------------------------------------------


def _train(tgraph, budget, dims=(16, 8), **knobs):
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    tt.gcn.hidden_layer_dims = list(dims)
    tt.gcn.epochs_per_level = 3
    tt.gcn.dropout_rate = 0.0
    tt.gcn.use_early_stopping = False
    tt.gcn.spmm_mode = "hypercube"
    for k, v in knobs.items():
        setattr(tt.gcn, k, v)
    tt._hbm_override = budget
    rng = np.random.default_rng(3)
    x = rng.normal(size=(tgraph.num_nodes, 12)).astype(np.float32)
    y = rng.integers(0, 5, tgraph.num_nodes).astype(np.int64)
    params, emb, cfg, _ = tt.train_level(tgraph, x, y, 5)
    return tt.level_stats[tgraph.n], params, emb, cfg


def _tier_need(tgraph, tier, dims=(16, 8), **knobs):
    tt = t_trainer.HierarchicalTrainer(TConfig(), device="cpu")
    tt.gcn.hidden_layer_dims = list(dims)
    for k, v in knobs.items():
        setattr(tt.gcn, k, v)
    _, alpha = t_trainer.vocab_char_codes(tgraph.vocab)
    cd, nd, rm, fc, rp = t_trainer.TIER_LEVERS[tier]
    fp32 = {"compute_dtype": "float32", "node_param_dtype": "float32"}
    cd, nd = (knobs.get(k, v) for k, v in zip(fp32, (cd, nd)))
    need = sum(tt._residency(alpha**tgraph.n, 12, 5, cd, nd, rm, fc, rp,
                             staged=tier == 4))
    return need + tt._PLAN_SLACK + tt._MIN_BANK


def test_train_level_at_tier_4_matches_tier_3(graphs, monkeypatch):
    """Both pins between their tier's need and the previous tier's, in
    float32 (the knobs force it at every tier), dropout 0: the staged level
    and the fused one from the same initial parameters give the same
    losses."""
    monkeypatch.setattr(t_trainer, "DirectGCNConfig",
                        lambda **kw: t_model.DirectGCNConfig(**kw, decoder_dropout=0.0))
    _, tg = graphs
    fp32 = dict(compute_dtype="float32", node_param_dtype="float32")
    runs = {}
    for tier in (3, 4):
        runs[tier] = _train(tg[1], _tier_need(tg[1], tier, **fp32), **fp32)[0]
    assert (runs[3]["plan"]["tier"], runs[4]["plan"]["tier"]) == (3, 4)
    assert (runs[3]["staged"], runs[4]["staged"]) == (False, True)
    assert runs[4]["plan"]["stage_split"] == 1 and runs[4]["route"] == "hypercube"
    np.testing.assert_allclose(runs[4]["losses"], runs[3]["losses"], rtol=STEP_RTOL)


def test_train_level_trains_the_degraded_dims(graphs):
    """A pin below tier 4's need at [64, 32]: the plan halves the dims
    until tier 4 fits, and the level trains at them."""
    _, tg = graphs
    need = _tier_need(tg[1], 4, dims=(64, 32))
    stats, params, emb, cfg = _train(tg[1], need - 1, dims=(64, 32))
    assert stats["plan"]["layer_dims_override"] == (32, 16)
    assert cfg.layer_dims == (12, 32, 16) and stats["layer_dims"] == [12, 32, 16]
    assert params["layers"][0]["w_main_in"].shape == (12, 32)
    assert emb.shape == (tg[1].num_nodes, 16) and np.isfinite(stats["losses"]).all()


# -----------------------------------------------------------------------------
# The literal layer
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "ell", "hypercube"])
def test_literal_layer_matches_jax(graphs, kind):
    jg, tg = graphs
    j_dev = jg[1].to_device(mode=kind)
    t_dev = tg[1].to_device(mode=kind, device="cpu")
    n = t_dev.num_nodes
    common = dict(layer_dims=(10, 16, 8), num_nodes=n, num_classes=6, n_gram_len=2,
                  dropout=0.0, decoder_dropout=0.0, fused=False)
    jcfg = j_model.DirectGCNConfig(**common)
    tcfg = t_model.DirectGCNConfig(**common)
    jp = j_model.init_directgcn_params(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, 10)).astype(np.float32)
    r = rng.normal(size=(n, 6)).astype(np.float32)

    def j_obj(p):
        ls, emb = j_model.directgcn_apply(p, j_dev, jnp.asarray(x), jcfg)
        return jnp.sum(ls * r) + jnp.sum(emb), (ls, emb)

    (_, (j_ls, j_emb)), j_grads = jax.value_and_grad(j_obj, has_aux=True)(jp)
    tp = convert.params_from_jax(jp, device="cpu")
    for p in t_model.param_leaves(tp):
        p.requires_grad_(True)
    ls, emb = t_model.directgcn_apply(tp, t_dev, torch.from_numpy(x), tcfg)
    (torch.sum(ls * torch.from_numpy(r)) + torch.sum(emb)).backward()
    np.testing.assert_allclose(ls.detach().numpy(), np.asarray(j_ls), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(j_emb), rtol=1e-5, atol=1e-5)
    j_leaves = dict(_leaves(j_grads))
    for path, t in _leaves(tp):
        ref = np.asarray(j_leaves[path]).reshape(tuple(t.shape))
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())),
                                   err_msg=str(path))
    # The fused layer computes the same function.
    fused = t_model.directgcn_apply(copy.deepcopy(convert.params_from_jax(jp, device="cpu")),
                                    t_dev, torch.from_numpy(x),
                                    t_model.DirectGCNConfig(**{**common, "fused": True}))[0]
    np.testing.assert_allclose(fused.numpy(), ls.detach().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("factored", [False, True])
def test_jax_optimizer_state_carries_into_the_port(graphs, staged, factored):
    """``convert.opt_state_from_jax``: two JAX steps (fused, or staged with
    its per-stage states), then the parameters and the optimizer state
    carried into the port; the third step of each package from there agrees
    at the three-step tolerance.  Factored: Adafactor on the node tables,
    bf16-free (float32) so that the moments compare closely."""
    jg, tg = graphs
    j_dev = jg[1].to_device(mode="hypercube")
    t_dev = tg[1].to_device(mode="hypercube", device="cpu")
    n, real = t_dev.num_nodes, tg[1].num_nodes
    dims = (10, 32, 16)
    common = dict(layer_dims=dims, num_nodes=n, num_classes=real, n_gram_len=2, dropout=0.0,
                  decoder_dropout=0.0, remat=True, remat_paths=factored)
    jcfg, tcfg = j_model.DirectGCNConfig(**common), t_model.DirectGCNConfig(**common)
    rng = np.random.default_rng(11)
    lead = t_dev.p_in.feature_shape
    x = rng.normal(size=lead + (dims[0],)).astype(np.float32)
    y = np.zeros(n, np.int64)
    mask = np.zeros(n, np.float32)
    y[t_dev.node_map.numpy()] = next_node_labels(tg[1])[0]
    mask[t_dev.node_map.numpy()] = 1.0
    jp = j_trainer._node_params_to_rg(
        j_model.init_directgcn_params(jax.random.PRNGKey(5), jcfg), j_dev)
    factor = n if factored else None

    def make_opt():
        return j_trainer.make_optimizer(1e-2, 1e-3, factor_node_params_above=factor)

    if staged:
        j_step = j_trainer.make_train_step_staged(jcfg, make_opt, 1e-4,
                                                  list(range(1, len(dims))))
        j_state = j_step.init_opt_state(jp)
    else:
        j_opt = make_opt()
        j_state = j_opt.init(jp)
        j_step = j_trainer.make_train_step(jcfg, j_opt, 1e-4)
    args = (j_dev, jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(mask),
            jnp.float32(1.0), jax.random.PRNGKey(0), None)
    for _ in range(2):
        jp, j_state, _, _ = j_step(jp, j_state, *args)
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.array, jp), device="cpu")
    for p in t_model.param_leaves(tp):
        p.requires_grad_(True)
    opt = t_trainer.make_optimizer(tp, 1e-2, 1e-3, factor_node_params_above=factor)
    convert.opt_state_from_jax(j_state, tp, opt)
    kinds = {"adam", "adafactor"} if factored else {"adam"}
    assert {g["kind"] for g in opt.param_groups} == kinds
    for p in t_model.param_leaves(tp):
        st = opt.state[p]
        assert st["step"] == 2 and all(v.dtype == torch.float32 for k, v in st.items()
                                       if k != "step")
    t_step = (t_trainer.make_train_step_staged if staged else t_trainer.make_train_step)(
        tcfg, opt, 1e-4)
    jp, j_state, j_loss, _ = j_step(jp, j_state, *args)
    t_loss, _ = t_step(tp, t_dev, torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(mask), 1.0, None)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=STEP_RTOL)
    _close(tp, jp, "third step from the carried state")
