"""GAT as a level model (``models/gat.py``, ``ops/gat_kernels.py``,
``csrc/gat.cu``) against the benchmark's plain reference
(``perfbench/reference/gat.py``: explicit per-edge tensors, segment max and
sum, ``index_add_``).

On the CPU: the attention table (self loops replaced by one a node,
duplicate edges kept, the transpose's slots naming the in-table slots); the
fused op's plain path against the reference, forward and every gradient,
at widths 256 and 121 with 4 and 6 heads, on graphs with nodes whose only
in-edge is the self loop, with self loops and with duplicate edges, and
float64 ``gradcheck`` at a tiny size; the port's model against the
reference on seeded weights (loss and each leaf's gradient); three steps of
``train_level`` under ``gcn.architecture="gat"`` against the reference's
``first_steps`` as the benchmark compares them; ``HierarchicalTrainer.run``
over n = 1..2 exporting embeddings; the plan; the spans and
``level_stats[n]["attention"]``; a default configuration still training
DirectGCN.

On the card (marked ``chip``; they skip without CUDA): the kernels against
their plain versions at widths 256, 121 and 37, forward and backward.  Run
there with ``python -m pytest --noconftest tests/test_torch_gat.py -q -m chip``
(``--noconftest``: the suite's conftest imports JAX).
"""

import numpy as np
import pytest
import torch

from perfbench.lib import check, runner
from perfbench.models import gat as bench_gat
from perfbench.reference import gat as ref_gat
from perfbench.reference import level as ref_level
from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
from protgram_directgcn_torch.models import gat as t_gat
from protgram_directgcn_torch.models.directgcn import named_leaves
from protgram_directgcn_torch.ops import gat_kernels as gk
from protgram_directgcn_torch.pipeline import trainer as t_trainer
from protgram_directgcn_torch.utils import profiling

SEQS = [
    ("P1", "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"),
    ("P2", "MKLVTAYIAKQRRQISFVK"),
    ("P3", "GLIEVQAPILSRVGDGTQDNLSGAEKAVQ"),
]
# Small GAT settings of the benchmark's configuration's shape.
SMALL_GCN = {"architecture": "gat", "hidden_layer_dims": [8, 6], "gat_heads": [2, 3, 2],
             "dropout_rate": 0.0, "lr": 0.005, "l2_reg_lambda": 0.0,
             "weight_decay": 0.0, "use_lr_scheduler": False, "use_early_stopping": False,
             "epochs_per_level": 3, "use_cluster_training": False}


@pytest.fixture(autouse=True, scope="module")
def _first_parallel_exp():
    """One multi-threaded ``torch.exp`` ahead of the comparisons: with
    PyTorch 2.13's CPU build at 8 threads, a process's first such call read
    1e-4 off on one thread's chunk of rows in 2 processes of 16, and none of
    30 once a call had gone before it."""
    torch.exp(-torch.rand(1 << 20) * 50)


@pytest.fixture(scope="module")
def graphs():
    return NgramGraphBuilder(n_max=3).build_from_sequences(SEQS)


def _graph(kind: str, n: int = 30, e: int = 90, seed: int = 0):
    """(src, tgt) of a random directed graph: "plain" (no self loop, no
    duplicate; nodes 0-2 have no in-edge), "loops" (with self loops) or
    "duplicates" (some edges twice)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    tgt = rng.integers(3, n, e)
    keep = src != tgt
    src, tgt = src[keep], tgt[keep]
    pairs = np.unique(np.stack([src, tgt], 1), axis=0)
    src, tgt = pairs[:, 0], pairs[:, 1]
    if kind == "loops":
        loops = np.array([3, 5, 5, 7])
        src, tgt = np.concatenate([src, loops]), np.concatenate([tgt, loops])
    elif kind == "duplicates":
        src, tgt = np.concatenate([src, src[:10]]), np.concatenate([tgt, tgt[:10]])
    return src.astype(np.int32), tgt.astype(np.int32)


def _ref_level(src, tgt, n: int) -> ref_gat.GatLevel:
    return ref_gat.from_edges(torch.as_tensor(src, dtype=torch.int64),
                              torch.as_tensor(tgt, dtype=torch.int64), n, 2)


# -----------------------------------------------------------------------------
# The table
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "loops", "duplicates"])
def test_table_holds_each_in_edge_once_and_one_self_loop_a_node(kind):
    n = 30
    src, tgt = _graph(kind, n)
    table = gk.build_table(src, tgt, n, device="cpu")
    want = sorted((int(s), int(t)) for s, t in zip(src, tgt) if s != t)
    want = sorted(want + [(i, i) for i in range(n)])
    idx, mask = table.idx.numpy(), table.mask.numpy()
    got = sorted((int(idx[i, k]), i) for i in range(n) for k in range(table.k) if mask[i, k])
    assert got == want and table.num_edges == len(want)
    assert table.idx.dtype == torch.int32 and table.k % 4 == 0
    # Each in-table slot names the transpose slot of the same edge, each
    # edge's once, and the transpose lists each source's targets.
    perm, idx_t = table.perm.numpy(), table.idx_t.numpy()
    flat_t = idx_t.reshape(-1)
    for i in range(n):
        for k in range(table.k):
            p = perm[i, k]
            assert (p >= 0) == bool(mask[i, k])
            if p >= 0:
                assert flat_t[p] == i and p // table.k_t == idx[i, k]
    real = perm[perm >= 0]
    assert len(set(real.tolist())) == len(real) == len(want)
    assert (real % table.k_t < np.bincount(real // table.k_t, minlength=n)[real // table.k_t]).all()


# -----------------------------------------------------------------------------
# The fused op's plain path against the reference
# -----------------------------------------------------------------------------


def _inputs(n: int, heads: int, width: int, seed: int, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn((n, heads * width), generator=gen, dtype=dtype)
    a_src = 2 * torch.randn((n, heads), generator=gen, dtype=dtype)
    a_dst = 2 * torch.randn((n, heads), generator=gen, dtype=dtype)
    cot = torch.randn((n, heads * width), generator=gen, dtype=dtype)
    return z, a_src, a_dst, cot


@pytest.mark.parametrize("kind", ["plain", "loops", "duplicates"])
@pytest.mark.parametrize("heads,width", [(4, 256), (6, 121), (2, 5)])
def test_fused_op_matches_the_reference_forward_and_gradients(kind, heads, width):
    """Forward within 2e-6 of the output's scale, each gradient within 2e-5
    of its own: the same sums in another order (the reference adds
    explicit per-edge messages with ``index_add_``)."""
    n = 30
    src, tgt = _graph(kind, n, seed=heads)
    table = gk.build_table(src, tgt, n, device="cpu")
    z, a_src, a_dst, cot = _inputs(n, heads, width, seed=width)
    leaves = [t.clone().requires_grad_(True) for t in (z, a_src, a_dst)]
    out = gk.gat_attention(*leaves, table)
    got = torch.autograd.grad(out, leaves, cot)
    ref_leaves = [t.clone().requires_grad_(True) for t in (z, a_src, a_dst)]
    zr, sr, dr = ref_leaves
    ref = ref_gat.attention(zr.reshape(n, heads, width), sr, dr, _ref_level(src, tgt, n),
                            block_elements=7 * heads * width).reshape(n, -1)
    want = torch.autograd.grad(ref, ref_leaves, cot)
    scale = float(ref.detach().abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-6 * scale)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5 * float(w.abs().max()))
    # Nodes 0-2 have only their self loop: alpha 1, the output their own z.
    torch.testing.assert_close(out[:3], z[:3], rtol=1e-6, atol=1e-6)


def test_fused_op_gradcheck_float64():
    n, heads, width = 7, 2, 3
    src, tgt = np.array([0, 1, 2, 2, 3, 4, 5, 5, 6]), np.array([1, 2, 1, 3, 3, 1, 4, 6, 6])
    table = gk.build_table(src, tgt, n, device="cpu")
    z, a_src, a_dst, _ = _inputs(n, heads, width, seed=3, dtype=torch.float64)
    leaves = [t.requires_grad_(True) for t in (z, a_src, a_dst)]
    assert torch.autograd.gradcheck(lambda a, b, c: gk.gat_attention(a, b, c, table), leaves,
                                    eps=1e-6, atol=1e-8)


def test_plain_versions_of_each_kernel_agree_with_autograd():
    """``edge_grad_plain`` (dpre and alpha placed in the transpose's layout)
    and the transposed ``aggregate_plain`` give the gradients that autograd
    takes through ``softmax_plain`` and ``aggregate_plain``."""
    n, heads, width = 30, 3, 4
    src, tgt = _graph("duplicates", n)
    table = gk.build_table(src, tgt, n, device="cpu")
    z, a_src, a_dst, cot = _inputs(n, heads, width, seed=9, dtype=torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in (z, a_src, a_dst)]
    alpha, lse = gk.softmax_plain(table.idx, table.mask, leaves[1], leaves[2])
    out = gk.aggregate_plain(table.idx, alpha, leaves[0])
    want = torch.autograd.grad(out, leaves, cot)
    dpre_t, alpha_t, d_a_dst = gk.edge_grad_plain(table.idx, table.mask, table.perm, table.k_t,
                                                  z, cot, out.detach(), a_src, a_dst,
                                                  lse.detach())
    real = table.perm.reshape(-1) >= 0
    torch.testing.assert_close(alpha_t.reshape(-1, heads)[table.perm.reshape(-1)[real].long()],
                               alpha.detach().reshape(-1, heads)[real])
    padding = torch.ones(n * table.k_t, dtype=torch.bool)
    padding[table.perm.reshape(-1)[real].long()] = False
    assert float(alpha_t.reshape(-1, heads)[padding].abs().sum()) == 0
    dz = gk.aggregate_plain(table.idx_t, alpha_t, cot)
    torch.testing.assert_close(dz, want[0])
    torch.testing.assert_close(dpre_t.sum(1), want[1])
    torch.testing.assert_close(d_a_dst, want[2])


@pytest.mark.parametrize("n_out,k,heads,width,aligned,v",
                         [(167_325, 24, 4, 256, True, 4), (167_325, 24, 6, 121, True, 1),
                          (1000, 8, 4, 256, False, 1), (50, 3, 6, 37, True, 1)])
def test_aggregate_launch_plan(n_out, k, heads, width, aligned, v):
    plan = gk.launch_plan(n_out, k, heads, width, aligned, n_out)
    nvec = heads * width // plan.v
    assert plan.v == v
    assert plan.grid[0] * plan.rows >= n_out > (plan.grid[0] - 1) * plan.rows
    assert plan.grid[1] * plan.ct >= nvec > (plan.grid[1] - 1) * plan.ct
    assert plan.threads % 32 == 0 and plan.threads <= 512
    assert 1 <= plan.kc <= k and plan.rows * plan.kc * 4 * (1 + heads) <= 49152


# -----------------------------------------------------------------------------
# The model against the reference
# -----------------------------------------------------------------------------


def test_model_matches_the_reference_on_seeded_weights():
    n, fin, classes = 40, 5, 7
    src, tgt = _graph("loops", n, e=150, seed=4)
    cfg = t_gat.GATConfig(in_dim=fin, hidden_dims=(8, 6), heads=(2, 3, 2), num_classes=classes)
    params = t_gat.init_gat_params(torch.Generator().manual_seed(11), cfg, device="cpu")
    specs = ref_gat.layers(fin, [8, 6], [2, 3, 2], classes)
    ref_params = ref_gat.init_params(11, specs, "cpu")
    names = [name for name, _ in named_leaves(params)]
    assert [p.shape for _, p in named_leaves(params)] == [p.shape for _, p in
                                                          ref_gat.named_leaves(ref_params)]
    for (_, a), (_, b) in zip(named_leaves(params), ref_gat.named_leaves(ref_params)):
        assert torch.equal(a, b)
    assert "res_w" in names and t_gat.param_count(cfg) == sum(p.numel() for _, p in
                                                              named_leaves(params))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((n, fin)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, classes, n))
    mask = torch.ones(n)
    table = gk.build_table(src, tgt, n, device="cpu")
    leaves = [p.requires_grad_(True) for _, p in named_leaves(params)]
    loss = t_trainer._GATLevel.loss(params, table, x, y, mask, None, cfg)
    got = torch.autograd.grad(loss, leaves)
    ref_leaves = [p.requires_grad_(True) for _, p in ref_gat.named_leaves(ref_params)]
    log_sm = ref_gat.forward(ref_params, specs, _ref_level(src, tgt, n), x)
    ref_loss = -torch.gather(log_sm, -1, y[:, None])[:, 0].mean()
    want = torch.autograd.grad(ref_loss, ref_leaves)
    torch.testing.assert_close(loss, ref_loss, rtol=2e-6, atol=0)
    for name, g, w in zip(names, got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5 * float(w.abs().max()) + 1e-12,
                                   msg=name)


def _gat_cfg(**gcn) -> dict:
    """A configuration of the benchmark's form; the level runs until the
    harness's window ends it."""
    return {"gcn": {**SMALL_GCN, "epochs_per_level": 10**9, **gcn}, "precision": "float32",
            "node_space": "vocabulary", "propagation_epsilon": 1e-9}


def test_train_level_matches_the_reference_first_steps(graphs):
    """Three steps of the program through ``train_level`` (read as the
    benchmark reads them) against ``perfbench/models/gat.py``'s
    ``first_steps`` on the same seed: the first loss within 1e-6, each
    leaf's first gradient and change within 1e-5 by ``check.compare``, the
    leaves paired one to one in the program's order."""
    graph = graphs[2]
    cfg = _gat_cfg()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((graph.num_nodes, 6)).astype(np.float32)
    y = rng.integers(0, 5, graph.num_nodes)
    seed = 2**31 + 77
    run = runner.run_program(cfg, graph, x, y, 5, seed, 0.0, False, torch.device("cpu"))
    runner.check_plan(run.plan, cfg)
    prog = {"losses": run.clock.losses, "grad_norms": run.recorder.grad_norms,
            "change_norms": run.recorder.change_norms, "numels": run.recorder.numels,
            "steps_at_checked": run.clock.steps_at_checked}
    level = bench_gat.reference_level(ref_level.graph_level(_fasta(), 3, "vocabulary", "cpu"),
                                      cfg, "cpu")
    ref = bench_gat.first_steps(level, cfg, x, y, 5, seed, runner.CHECKED_STEPS, "cpu")
    numbers, notes = check.compare(prog, ref)
    assert numbers["first_loss_gap"] < 1e-6, notes
    assert numbers["grad_gap"] < 1e-5 and numbers["change_gap"] < 1e-5, (numbers, notes)
    assert ref["names"][:6] == ["layers.0.att_dst", "layers.0.att_src", "layers.0.b",
                                "layers.0.w", "layers.1.att_dst", "layers.1.att_src"]
    half = bench_gat.first_steps(level, cfg, x, y, 5, seed, runner.CHECKED_STEPS, "cpu",
                                 half_batch=True)
    assert check.compare({**ref, "steps_at_checked": [1, 2, 3]}, half)[0]["grad_gap"] > 1e-3


_FASTA = {}


def _fasta() -> str:
    """The FASTA of ``SEQS`` (the reference re-derives the graph from it)."""
    if "path" not in _FASTA:
        import tempfile

        path = tempfile.NamedTemporaryFile("w", suffix=".fasta", delete=False)
        for name, seq in SEQS:
            path.write(f">sp|{name}|X\n{seq}\n")
        path.close()
        _FASTA["path"] = path.name
    return _FASTA["path"]


# -----------------------------------------------------------------------------
# The trainer: plan, run, spans, the DirectGCN default
# -----------------------------------------------------------------------------


def _trainer(**gcn) -> t_trainer.HierarchicalTrainer:
    cfg = Config().apply_overrides({f"gcn.{k}": v for k, v in {**SMALL_GCN, **gcn}.items()})
    cfg.random_state = 3
    return t_trainer.HierarchicalTrainer(cfg, device="cpu")


def test_plan_is_tier0_float32_or_raises(graphs):
    tt = _trainer()
    plan = tt._level_plan(graphs[2], 6, 5)
    assert (plan.tier, plan.compute_dtype, plan.node_param_dtype, plan.remat,
            plan.layer_dims_override) == (0, "float32", "float32", False, None)
    gat = t_trainer._LEVEL_MODELS["gat"]
    assert plan.residency == gat.residency(graphs[2], gat.config(tt, 6, 5)) > 0
    tt._hbm_override = plan.residency
    with pytest.raises(ValueError, match="tier 0"):
        tt._level_plan(graphs[2], 6, 5)
    with pytest.raises(ValueError, match="forces"):
        _trainer(compute_dtype="bfloat16")._level_plan(graphs[2], 6, 5)
    with pytest.raises(ValueError, match="architecture"):
        _trainer(architecture="gcn")._level_plan(graphs[2], 6, 5)


@pytest.mark.parametrize("lever", [{"remat": True}, {"node_param_dtype": "bfloat16"},
                                   {"dropout_rate": 0.5}])
def test_plan_refuses_a_forced_lever(graphs, lever):
    """A lever that a GAT level does not take raises, dropout among them
    (the configuration's default 0.5 included): nothing is ignored."""
    with pytest.raises(ValueError, match="forces"):
        _trainer(**lever)._level_plan(graphs[2], 6, 5)


def test_skip_on_every_hidden_layer_after_the_first():
    cfg = t_gat.GATConfig(in_dim=6, hidden_dims=(8, 6, 4), heads=(2, 3, 2, 2), num_classes=5)
    assert [s.residual for s in cfg.layers()] == [False, True, True, False]
    ref = ref_gat.layers(6, [8, 6, 4], [2, 3, 2, 2], 5)
    assert [(s.in_dim, s.heads, s.width, s.concat, s.residual) for s in ref] == [
        tuple(s) for s in cfg.layers()]


def test_gat_level_trains_on_its_table_with_spans_and_counters(graphs):
    graph = graphs[1]
    tt = _trainer(epochs_per_level=2)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((graph.num_nodes, 6)).astype(np.float32)
    y = rng.integers(0, 4, graph.num_nodes)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        params, embeds, cfg, table = tt.train_level(graph, x, y, 4)
        names = [s.name for s in profiling.spans()]
    assert names.count("ops.gat_attn") >= 2 * 3 and names.count("ops.gat_attn_bwd") == 2 * 3
    st = tt.level_stats[2]
    att = st["attention"]
    assert isinstance(table, gk.GatTable) and st["route"] == "gat_ell"
    assert att["heads"] == [2, 3, 2] and att["widths"] == [8, 6, 4]
    assert att["edges"] == table.num_edges and att["k"] == table.k and att["route"] == "plain"
    assert att["launches"]["gat_aggregate"] == {"fwd": 0, "bwd": 0}
    assert set(att["launches_per_step"]) == {"gat_softmax", "gat_aggregate", "gat_edge_grad"}
    assert embeds.shape == (graph.num_nodes, 18) and isinstance(cfg, t_gat.GATConfig)
    np.testing.assert_allclose(np.linalg.norm(embeds, axis=1), 1.0, rtol=1e-5)
    assert "operators.build" in st["spans"] and "operators.transforms" not in st["spans"]


def test_run_exports_gat_embeddings(tmp_path):
    fasta = tmp_path / "demo.fasta"
    fasta.write_text("".join(f">sp|{n}|X {n}\n{s}\n" for n, s in SEQS))
    cfg = Config().apply_overrides({
        **{f"gcn.{k}": v for k, v in SMALL_GCN.items()}, "gcn.one_gram_init_dim": 8,
        "gcn.apply_pca": False, "gcn.run_sanity_check_ppi": False,
        "graph_builder.ngram_max_n": 2, "id_mapping_mode": "none"})
    graph_paths = NgramGraphBuilder(n_max=2).run(str(fasta), str(tmp_path / "graphs"))
    assert len(graph_paths) == 2
    tt = t_trainer.HierarchicalTrainer(cfg, device="cpu")
    path = tt.run(fasta, tmp_path / "graphs", tmp_path / "out")
    from protgram_directgcn_torch.utils.io import read_embeddings

    emb = read_embeddings(path)
    assert len(emb) == len(SEQS) and all(v.shape == (18,) for v in emb.values())
    assert tt.level_stats[1]["attention"]["heads"] == [2, 3, 2]
    assert tt.level_stats[2]["route"] == "gat_ell"


def test_default_configuration_trains_directgcn(graphs):
    """``gcn.architecture`` defaults to "directgcn": the level builds the
    three operators and DirectGCN's leaves, and trains as the configuration
    that names it."""
    assert Config().gcn.architecture == "directgcn"
    graph = graphs[2]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((graph.num_nodes, 6)).astype(np.float32)
    y = rng.integers(0, 3, graph.num_nodes)
    runs = []
    for over in ({}, {"gcn.architecture": "directgcn"}):
        cfg = Config().apply_overrides({"gcn.hidden_layer_dims": [8, 4], "gcn.epochs_per_level": 2,
                                        "gcn.spmm_mode": "pallas", **over})
        tt = t_trainer.HierarchicalTrainer(cfg, device="cpu")
        params, _, mcfg, dg = tt.train_level(graph, x, y, 3)
        runs.append((params, tt.level_stats[3], dg))
    (p0, st0, dg0), (p1, st1, _) = runs
    assert "attention" not in st0 and st0["route"] == "ell" and dg0.p_und is not None
    assert st0["losses"] == st1["losses"]
    names = [n for n, _ in named_leaves(p0)]
    assert {"w_main_in", "w_shared", "constant", "c_all", "w1"} <= set(names)
    for (_, a), (_, b) in zip(named_leaves(p0), named_leaves(p1)):
        assert torch.equal(a, b)


def test_run_cell_on_the_cpu_reads_correct_with_a_small_mix(tmp_path):
    """The benchmark's cell end to end on the CPU at a small mix: the
    program through ``train_level``, the reference, the comparison."""
    from perfbench.lib import manifest

    bench = manifest.benchmark()
    cell = manifest.workload(bench, "gat.ngram4")
    mix = {"corpus": {"sequences": 60, "min_length": 20, "max_length": 60, "data_seed": 5},
           "n": 2, "feat_dim": 8, "num_classes": 121}
    res = runner.run_cell(bench, cell, 2**31 + 5, 0.5, False, torch.device("cpu"),
                          cache_root=tmp_path, mix=mix)
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {"step_ms", "setup_s"}


# -----------------------------------------------------------------------------
# On the card
# -----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gk.build()
    return torch.device("cuda", 0)


@pytest.mark.chip
@pytest.mark.parametrize("heads,width", [(4, 256), (6, 121), (3, 37)])
def test_kernels_match_their_plain_versions_on_the_card(cuda_device, heads, width):
    """Every launch against its plain version on the card's tensors: alpha
    within 4e-6 of itself and lse within 1e-6 (expf and logf against
    torch.exp and torch.log, a few ulps), the output, dz, d_a_src and d_a_dst within 3e-5 of
    their largest element (the same sums in another order, expf against
    torch.exp; d_a_dst sums terms that mostly cancel), as ``chip_smoke.py``'s
    ``GAT_TOL``."""
    n = 5000
    src, tgt = _graph("duplicates", n, e=60_000, seed=heads)
    table = gk.build_table(src, tgt, n, device=cuda_device)
    z, a_src, a_dst, cot = (t.to(cuda_device) for t in _inputs(n, heads, width, seed=width))
    gk.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (z, a_src, a_dst)]
    out = gk.gat_attention(*leaves, table)
    got = torch.autograd.grad(out, leaves, cot)
    torch.cuda.synchronize()
    assert gk.launch_counts() == {"gat_softmax": {"fwd": 1}, "gat_aggregate": {"fwd": 1, "bwd": 1},
                                  "gat_edge_grad": {"bwd": 1}}
    alpha, lse = gk.softmax(table.idx, table.mask, a_src, a_dst)
    alpha_p, lse_p = gk.softmax_plain(table.idx, table.mask, a_src, a_dst)
    torch.testing.assert_close(alpha, alpha_p, rtol=4e-6, atol=1e-7)
    torch.testing.assert_close(lse, lse_p, rtol=1e-6, atol=1e-6)
    out_p = gk.aggregate_plain(table.idx, alpha_p, z)
    dpre_t, alpha_t, d_a_dst = gk.edge_grad_plain(table.idx, table.mask, table.perm, table.k_t,
                                                  z, cot, out_p, a_src, a_dst, lse_p)
    want = (gk.aggregate_plain(table.idx_t, alpha_t, cot), dpre_t.sum(1), d_a_dst)
    torch.testing.assert_close(out, out_p, rtol=0, atol=3e-5 * float(out_p.abs().max()))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=3e-5 * float(w.abs().max()))


def test_entry_points_are_declared_with_their_c_signatures(monkeypatch):
    """``build`` gives each entry point of ``csrc/gat.cu`` the ctypes types
    of its C signature, pointer for pointer and int for int (a wrong count
    refuses every call, and only the card would show it)."""
    import ctypes
    import re
    import types

    from protgram_directgcn_torch.ops import _nvcc

    source = (_nvcc.CSRC / "gat.cu").read_text()
    declared = {}
    fake = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in
                                    ("gat_softmax_f32", "gat_aggregate_f32",
                                     "gat_edge_grad_f32")})
    monkeypatch.setattr(gk, "_lib", None)
    monkeypatch.setattr(gk._nvcc, "compile_source", lambda name: {"path": "x.so"})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: fake)
    gk.build()
    for name in ("gat_softmax_f32", "gat_aggregate_f32", "gat_edge_grad_f32"):
        params = re.search(rf"int {name}\(([^)]*)\)", source).group(1).split(",")
        want = [ctypes.c_void_p if "void*" in p else ctypes.c_int for p in params]
        declared[name] = getattr(fake, name).argtypes
        assert declared[name] == want, name
        assert getattr(fake, name).restype is ctypes.c_int
    gk.BUILD_INFO.clear()

