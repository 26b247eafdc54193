"""The optimizer's pass over the parameters (``ops/optim_kernels.py``,
``csrc/optim.cu``) and the train step that hands it the L2 term.

On the CPU: the step with the L2 term out of autograd (its value the
leaves' sum of squares, its gradient ``2 * l2_lambda * p`` added inside the
update) against the old form, the term inside autograd, on dense, hypercube
and ELL levels: the loss within the order of a sum, the gradient the update
takes (read from Adam's first moment) within a few float32 ulps; the
tables the wrapper hands each launch; the routes ``level_stats`` records.

On the card (marked ``chip``; they skip without CUDA): the Adam kernel
against its plain version (the same optimizer on CPU copies) over 4 steps,
and the sum-of-squares kernel against the plain sum.  Run there with
``python -m pytest --noconftest tests/test_torch_optim_kernels.py -q -m chip``
(``--noconftest``: the suite's conftest imports JAX).
"""

import numpy as np
import pytest
import torch

from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
from protgram_directgcn_torch.models import directgcn as t_model
from protgram_directgcn_torch.ops import optim_kernels as ok
from protgram_directgcn_torch.ops import spmm as t_spmm
from protgram_directgcn_torch.pipeline import trainer as t_trainer

SEQS = [
    ("P1", "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"),
    ("P2", "MKLVTAYIAKQRRQISFVK"),
    ("P3", "GLIEVQAPILSRVGDGTQDNLSGAEKAVQ"),
]
B1 = t_trainer._ADAM_B1


@pytest.fixture(scope="module")
def graphs():
    return NgramGraphBuilder(n_max=3).build_from_sequences(SEQS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ok.build()
    return torch.device("cuda", 0)


# -----------------------------------------------------------------------------
# The step: the L2 term out of autograd (CPU)
# -----------------------------------------------------------------------------


def _level(graphs, kind, level):
    dev = graphs[level - 1].to_device(mode=kind, device="cpu")
    n = dev.num_nodes
    dims = (10, 8, 6)
    cfg = t_model.DirectGCNConfig(layer_dims=dims, num_nodes=n, num_classes=5, n_gram_len=level,
                                  one_gram_dim=dims[0] if level == 1 else 0, max_pe_len=8,
                                  dropout=0.0, decoder_dropout=0.0)
    rng = np.random.default_rng(level)
    x = torch.from_numpy(rng.normal(size=(n, dims[0])).astype(np.float32))
    if kind == "hypercube":
        x = x.reshape(dev.p_in.feature_shape + (dims[0],))
    y = torch.from_numpy(rng.integers(0, 5, n).astype(np.int64))
    mask = torch.from_numpy((rng.random(n) < 0.8).astype(np.float32))
    return dev, cfg, x, y, mask


def _params(cfg):
    p = t_model.init_directgcn_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    for leaf in t_model.param_leaves(p):
        leaf.requires_grad_(True)
    return p


@pytest.mark.parametrize("weight_factor", [1.0, 0.75])
@pytest.mark.parametrize("kind,level", [("dense", 1), ("dense", 3), ("hypercube", 3),
                                        ("ell", 3)])
def test_step_with_l2_out_of_autograd_matches_the_term_in_autograd(monkeypatch, graphs, kind,
                                                                    level, weight_factor):
    """The old form: ``primary * weight_factor + l2 * sum(p.float() ** 2)``
    differentiated by autograd, then the same optimizer with no L2 of its
    own.  Loss within rtol 1e-6 (the sum of squares in another order).  The
    first moment, (1 - b1) times the gradient the update took, within 2
    float32 ulps of the leaf's largest gradient (1.23 at most here):
    ``(2 l) * p`` and ``l * (2 p)`` are the same product, but a leaf used
    in several places sums its gradient over the uses, and the L2 term
    joined that sum at another point.  The parameters after the step
    within rtol 2.5e-7 and 1e-6 of a unit step (lr): Adam's first step
    divides the gradient by its magnitude plus 1e-8, so an element whose
    gradient is near 1e-8 turns an ulp of it into a share of the step
    (3e-7 of it at most here)."""
    if kind == "ell":
        monkeypatch.setattr(t_spmm, "_on_card", lambda t: True)
    l2 = 1e-3
    dev, cfg, x, y, mask = _level(graphs, kind, level)

    old = _params(cfg)
    opt_old = t_trainer.make_optimizer(old, 1e-2, 0.0)
    primary = t_trainer._primary_loss(old, dev, x, y, mask, None, cfg)
    l2_old = sum(torch.sum(torch.square(p.float())) for p in t_model.param_leaves(old))
    loss_old = primary * weight_factor + l2 * l2_old
    loss_old.backward()
    g_old = [p.grad.clone() for p in t_model.param_leaves(old)]
    opt_old.step()

    new = _params(cfg)
    opt_new = t_trainer.make_optimizer(new, 1e-2, 0.0)
    step = t_trainer.make_train_step(cfg, opt_new, l2)
    loss_new, primary_new = step(new, dev, x, y, mask, weight_factor, None)

    assert float(primary_new) == float(primary.detach())
    np.testing.assert_allclose(float(loss_new), float(loss_old), rtol=1e-6)
    for (name, p_new), p_old, g in zip(t_model.named_leaves(new), t_model.param_leaves(old),
                                       g_old):
        mu_new, mu_old = opt_new.state[p_new]["mu"], opt_old.state[p_old]["mu"]
        ulp = torch.finfo(torch.float32).eps * (1 - B1) * float(g.abs().max())
        assert float((mu_new - mu_old).abs().max()) <= 2 * ulp, name
        np.testing.assert_allclose(p_new.detach().numpy(), p_old.detach().numpy(),
                                   rtol=2.5e-7, atol=1e-6 * 1e-2, err_msg=name)


def test_step_without_l2_leaves_the_loss_the_weighted_primary(graphs):
    dev, cfg, x, y, mask = _level(graphs, "dense", 3)
    params = _params(cfg)
    opt = t_trainer.make_optimizer(params, 1e-2, 1e-2)
    loss, primary = t_trainer.make_train_step(cfg, opt, 0.0)(params, dev, x, y, mask, 0.5, None)
    assert float(loss) == float(primary * 0.5)
    assert opt.l2_lambda == 0.0 and opt._decay(opt.param_groups[0]) == 1e-2


def test_sum_of_squares_counts_the_leaves_with_a_gradient():
    leaves = [torch.full((3, 2), 2.0), torch.full((5,), -1.0), torch.ones(4)]
    opt = t_trainer.TrainOptimizer([{"params": leaves, "kind": "adam"}],
                                   {"lr": 1e-2, "weight_decay": 0.0})
    assert opt.sum_of_squares() is None
    leaves[0].grad = torch.zeros(3, 2)
    leaves[1].grad = torch.zeros(5)
    assert float(opt.sum_of_squares()) == 24.0 + 5.0


@pytest.mark.parametrize("chunk", [1 << 25, 7])
def test_plain_sum_of_squares_against_float64(chunk):
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=s).astype(np.float32) for s in [(1,), (7,), (33, 5), (2, 3, 4)]]
    ts = [torch.from_numpy(a) for a in arrays] + [torch.from_numpy(arrays[2]).bfloat16()]
    want = sum(float(np.sum(np.square(t.float().numpy().astype(np.float64)))) for t in ts)
    got = ok.sum_squares(ts, chunk)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_level_stats_record_the_update_routes(graphs):
    cfg = Config()
    cfg.apply_overrides({"gcn.hidden_layer_dims": [8, 6], "gcn.epochs_per_level": 2,
                         "gcn.use_early_stopping": False, "gcn.spmm_mode": "dense",
                         "gcn.use_cluster_training": False})
    tt = t_trainer.HierarchicalTrainer(cfg, device="cpu")
    graph = graphs[1]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(graph.num_nodes, 6)).astype(np.float32)
    y = rng.integers(0, 4, graph.num_nodes).astype(np.int64)
    params = tt.train_level(graph, x, y, 4)[0]
    leaves = t_model.param_leaves(params)
    st = tt.level_stats[2]["optimizer"]
    assert st["plain"] == {"leaves": len(leaves), "elements": sum(p.numel() for p in leaves)}
    assert st["fused"] == {"leaves": 0, "elements": 0} == st["adafactor"]
    assert st["launches"] == {"adam": 0, "l2": 0}


# -----------------------------------------------------------------------------
# The wrapper's tables (CPU: no launch)
# -----------------------------------------------------------------------------


def test_tables_split_at_the_launch_capacity_and_flag_alignment():
    n = ok.TABLE_LEAVES + 5
    ps = [torch.zeros(3, dtype=torch.bfloat16 if i % 3 == 0 else torch.float32)
          for i in range(n)]
    ptrs = np.array([[4096 * (i + 1) + (4 if i == 1 else 0) for i in range(n)],
                     [8192 * (i + 1) + (8 if i == 3 else 0) for i in range(n)],
                     [4096 * (i + 1) for i in range(n)],
                     [4096 * (i + 1) + (8 if i == 0 else 0) for i in range(n)]], dtype=np.int64)
    tables = list(ok._tables(ps, ptrs))
    assert [len(numel) for _, numel, _ in tables] == [ok.TABLE_LEAVES, 5]
    flags = np.concatenate([f for _, _, f in tables])
    bf16 = np.array([p.dtype == torch.bfloat16 for p in ps])
    assert ((flags & ok._BF16) > 0).tolist() == bf16.tolist()
    aligned = (flags & ok._ALIGNED) > 0
    # Leaf 0 (bf16): nu 8 bytes off 16; leaf 1 (f32): p 4 bytes off;
    # leaf 3 (bf16): g 8 bytes off 16, enough for 4 bf16 elements.
    assert not aligned[0] and not aligned[1] and aligned[3] and aligned[2]
    cols = np.concatenate([c for c, _, _ in tables], axis=1)
    assert (cols == ptrs).all() and all(c.flags["C_CONTIGUOUS"] for c, _, _ in tables)


def test_cpu_leaves_take_the_plain_version_and_count_no_launch():
    ok.reset_launches()
    p = torch.ones(4)
    p.grad = torch.full((4,), 0.5)
    mu, nu = torch.zeros(4), torch.zeros(4)
    ok.adam([p], [mu], [nu], 1e-2, 0.9, 0.999, 1e-8, *t_trainer.adam_bias_corrections(1), 0.0,
            t_trainer._UPDATE_CHUNK)
    assert ok.launch_counts() == {"adam": 0, "l2": 0}
    np.testing.assert_allclose(p.numpy(), 1.0 - 1e-2, rtol=1e-6)
    np.testing.assert_allclose(mu.numpy(), 0.05, rtol=1e-6)


def test_leaves_on_two_devices_are_refused():
    a, b = torch.ones(2), torch.ones(2, device="meta")
    with pytest.raises(ValueError, match="more than one device"):
        ok.sum_squares([a, b], 8)


# -----------------------------------------------------------------------------
# On the card
# -----------------------------------------------------------------------------

SIZES = [(1,), (7,), ((1 << 16) + 3,), (33, 17), (64, 40)]


def _leaves(rng, dev):
    """f32 and bf16 leaves of ragged sizes, one misaligned (a view one
    element into a buffer), and enough small ones that the table takes two
    launches."""
    def normal(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    out = [normal(shape).to(dtype).to(dev) for dtype in (torch.float32, torch.bfloat16)
           for shape in SIZES]
    misaligned = torch.zeros(1001, device=dev)[1:]
    misaligned.copy_(normal(1000))
    out.append(misaligned)
    return out + [normal((i % 5) + 1).to(dev) for i in range(ok.TABLE_LEAVES)]


@pytest.mark.chip
@pytest.mark.parametrize("decay", ["none", "weight_decay", "l2"])
def test_adam_kernel_matches_its_plain_version(cuda_device, decay):
    """Four steps of the same optimizer on the card (the kernel) and on CPU
    copies (the plain version), each held from the plain version's state.
    f32 leaves within rtol 2.5e-7 / atol 2e-9 (``test_optimizer_matches_jax``),
    their moments within 2 ulps of the terms each sums (b1 * mu and
    (1 - b1) * g' may cancel, and one version fuses a multiply into the add
    where the other rounds it); bf16 leaves and their moments within one
    bf16 ulp of the same (2^-7 of the value or the terms, and of the step).
    Leaf 0 has no gradient at step 1 (so the group holds two step counts
    after it) and the last leaf never has one (skipped)."""
    rng = np.random.default_rng(11)
    card = _leaves(rng, cuda_device)
    host = [t.cpu().clone() for t in card]
    wd = 1e-2 if decay == "weight_decay" else 0.0
    opts = [t_trainer.TrainOptimizer([{"params": ps, "kind": "adam"}],
                                     {"lr": 1e-2, "weight_decay": wd}) for ps in (card, host)]
    for opt in opts:
        opt.l2_lambda = 1e-3 if decay == "l2" else 0.0
    c_eff = opts[1]._decay(opts[1].param_groups[0])
    b2 = t_trainer._ADAM_B2
    ok.reset_launches()
    for step in range(4):
        for i, (c, h) in enumerate(zip(card, host)):
            if (i == 0 and step == 0) or i == len(card) - 1:
                c.grad = h.grad = None
                continue
            g = torch.from_numpy(rng.normal(size=tuple(c.shape)).astype(np.float32)).to(c.dtype)
            h.grad, c.grad = g, g.to(cuda_device)
        prev = [(h.detach().float().clone(), opts[1].state[h]["mu"].clone(),
                 opts[1].state[h]["nu"].clone()) if h in opts[1].state
                else (h.detach().float().clone(), torch.zeros(h.shape), torch.zeros(h.shape))
                for h in host]
        for opt in opts:
            opt.step()
        torch.cuda.synchronize()
        for i, (c, h) in enumerate(zip(card, host)):
            if h.grad is None:
                assert (c in opts[0].state) == (i == 0 and step > 0)
                continue
            got = [c.detach().cpu().float(), opts[0].state[c]["mu"].cpu(),
                   opts[0].state[c]["nu"].cpu()]
            want = [h.detach().float(), opts[1].state[h]["mu"], opts[1].state[h]["nu"]]
            p0, mu0, nu0 = prev[i]
            g = h.grad.float().abs() + c_eff * p0.abs()
            terms = [B1 * mu0.abs() + (1 - B1) * g, b2 * nu0 + (1 - b2) * g * g]
            if c.dtype == torch.float32:
                np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=2.5e-7,
                                           atol=2e-9, err_msg=str((step, i)))
                room = [2.0**-22 * t for t in terms]
            else:
                assert bool(((got[0] - want[0]).abs()
                             <= 2.0**-7 * (want[0].abs() + 1e-2)).all()), (step, i)
                room = [2.0**-7 * t for t in terms]
            for a, b, r in zip(got[1:], want[1:], room):
                assert bool(((a - b).abs() <= r + 1e-30).all()), (step, i)
            # The next step starts from the plain version's state.
            with torch.no_grad():
                c.copy_(h.to(cuda_device))
                opts[0].state[c]["mu"].copy_(opts[1].state[h]["mu"])
                opts[0].state[c]["nu"].copy_(opts[1].state[h]["nu"])
    # Step 1: one step count over all but two leaves (two tables); then two
    # step counts, leaf 0 alone in one of them.
    assert ok.launch_counts()["adam"] == 2 + 3 * 3
    counts = opts[0].update_counts()
    assert counts["plain"] == {"leaves": 0, "elements": 0}
    assert counts["fused"]["leaves"] == len(card) - 1


@pytest.mark.chip
def test_sum_of_squares_kernel_matches_the_plain_sum(cuda_device):
    """One launch a table; within rtol 1e-6 of the plain version, and of a
    float64 sum."""
    rng = np.random.default_rng(12)
    card = _leaves(rng, cuda_device)
    ok.reset_launches()
    got = ok.sum_squares(card, t_trainer._UPDATE_CHUNK)
    again = ok.sum_squares(card, t_trainer._UPDATE_CHUNK)  # the counter was left at 0
    assert ok.launch_counts()["l2"] == 2 * 2
    want = ok.sum_squares_plain([t.cpu() for t in card], t_trainer._UPDATE_CHUNK)
    exact = sum(float(torch.sum(t.cpu().double() ** 2)) for t in card)
    assert float(got) == float(again)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(got), exact, rtol=1e-6)
    one = ok.sum_squares(card[:3], t_trainer._UPDATE_CHUNK)
    np.testing.assert_allclose(float(one), sum(float(torch.sum(t.cpu().double() ** 2))
                                               for t in card[:3]), rtol=1e-6)
