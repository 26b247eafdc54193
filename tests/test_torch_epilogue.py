"""The DirectGCN layer's elementwise tail (``ops/epilogue_kernels.py``,
``csrc/epilogue.cu``).

On the CPU: the plain version against the literal composition the model
ran (bias adds, gating, constant, residual, leaky ReLU, dropout), forward
and every leaf's gradient, bit for bit, and under ``gradcheck`` in float64;
the fused op's autograd through its plain stand-ins for the kernels
(``_on_card`` made true): its forward bit for bit, the paths' cotangents
and ``ds`` bit for bit, the gates' and biases' sums (another order) within
``SUM_RTOL`` of the largest element, and ``gradcheck`` in float64; vector
and scalar gates, dropout on and off, s exactly 0 (torch's branch of the
kink), gathered gates (the cluster path), an rg carry; the engage rule
(CPU, bf16, a feature shard and a packed rg carry take the plain route)
and ``level_stats[n]["epilogue"]``.

On the card (marked ``chip``; they skip without CUDA): at the benchmark
cells' shapes (N = 194,481 as an rg carry [21, 9261, F], N = 167,325 flat;
F = 256 / 128 / 64) the f32 forward equal to the plain chain to the bit,
the paths' cotangents and ``ds`` equal to the bit, the gates' and biases'
gradients within ``SUM_RTOL``; and two launches a layer a step.  Run there
with ``python -m pytest --noconftest tests/test_torch_epilogue.py -q -m chip``
(``--noconftest``: the suite's conftest imports JAX, which this file does
not).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
from protgram_directgcn_torch.models import directgcn as t_model
from protgram_directgcn_torch.ops import epilogue_kernels as ek
from protgram_directgcn_torch.pipeline import trainer as t_trainer

SEQS = [
    ("P1", "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"),
    ("P2", "MKLVTAYIAKQRRQISFVK"),
    ("P3", "GLIEVQAPILSRVGDGTQDNLSGAEKAVQ"),
]
SLOPE = 0.01
# A gate's gradient sums F products of a row, a bias's N of a column; the
# two routes add them in other orders.  Allowance: this share of the
# gradient's largest element.
SUM_RTOL = 1e-5
PATHS = ("pi", "po", "pu")
BIASES = ("b_in", "b_out", "b_und")
GATES = ("c_in", "c_out", "c_dir", "c_und", "c_all")


def literal(pi, po, pu, b_in, b_out, b_und, gates, const, res, slope, keep, u):
    """The model's tail as it was written in ``models/directgcn.py``:
    ``_layer_apply``'s bias adds, ``_combine_paths``, then ``layer_block``'s
    residual add, leaky ReLU and ``_dropout``'s where."""
    c_in, c_out, c_dir, c_und, c_all = gates
    ic, oc, uc = pi + b_in, po + b_out, pu + b_und
    directed = c_dir * (c_in * ic + c_out * oc)
    undirected = c_und * uc
    gcn_out = c_all * (undirected + directed) + const
    out = F.leaky_relu(gcn_out + res, negative_slope=slope)
    if u is None:
        return out
    return torch.where(u < keep, out / keep, torch.zeros((), dtype=out.dtype, device=out.device))


@dataclasses.dataclass
class Case:
    """One tail's operands: ``leaves`` require grad; ``gates`` and
    ``const`` as the model hands them (viewed or gathered from the leaves)."""

    leaves: dict
    gates: tuple
    const: torch.Tensor
    u: object
    keep: float

    def args(self):
        lv = self.leaves
        return ([lv[k] for k in PATHS] + [lv[k] for k in BIASES]
                + [self.gates, self.const, lv["res"]])


def make_case(shape=(6, 5), gates="vector", dropout=True, dtype=torch.float64, seed=0,
              gather=None, keep=0.5, device="cpu") -> Case:
    """Operands of a tail on a carry of ``shape`` (``[R, F]``, or rg
    ``[A, G, F]``).  ``gates``: "vector" ([N, 1], viewed rg on an rg carry)
    or "scalar" ((1,)); ``gather``: node ids at which [N, 1] gate tables
    and an [N, F] constant are gathered (the cluster path)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.float64 if torch.device(device).type == "cpu" else torch.float32
    f = shape[-1]
    rows = int(np.prod(shape[:-1]))

    def leaf(sh, scale=1.0, loc=0.0):
        t = loc + scale * torch.randn(sh, generator=gen, device=device, dtype=draw)
        return t.to(dtype).requires_grad_(True)

    leaves = {k: leaf(shape) for k in PATHS + ("res",)}
    leaves.update({k: leaf((f,), 0.3) for k in BIASES})
    table_rows = rows if gather is None else int(max(gather)) + 3
    gate_shape = (table_rows, 1) if gates == "vector" else (1,)
    leaves.update({k: leaf(gate_shape, 0.3, 1.0) for k in GATES})
    leaves["const"] = leaf((table_rows, f) if gather is not None else shape, 0.5)
    gs = tuple(leaves[k] for k in GATES)
    const = leaves["const"]
    if gather is not None:
        idx = torch.as_tensor(gather, device=device)
        gs = tuple(g[idx] if g.dim() == 2 else g for g in gs)
        const = const[idx]
    if len(shape) == 3 and gates == "vector":
        gs = tuple(g.reshape(shape[:2] + (1,)) for g in gs)
    u = torch.rand(shape, generator=gen, device=device, dtype=draw).to(dtype) if dropout else None
    return Case(leaves, gs, const, u, keep)


def grads(fn, case: Case, seed=1):
    """(out, {leaf: gradient}) of ``sum(out * dout)`` for a seeded dout."""
    out = fn(*case.args(), SLOPE, case.keep, case.u)
    gen = torch.Generator(device=out.device).manual_seed(seed)
    dout = torch.randn(out.shape, generator=gen, device=out.device, dtype=out.dtype)
    names = list(case.leaves)
    got = torch.autograd.grad((out * dout).sum(), [case.leaves[k] for k in names],
                              allow_unused=True)
    return out.detach(), dict(zip(names, got)), dout


@pytest.fixture
def card_stand_in(monkeypatch):
    """CPU tensors take the fused op, with the kernels' plain versions."""
    monkeypatch.setattr(ek, "_on_card", lambda t: True)
    ek.reset_launches()


def assert_routes_agree(plain, fused, exact=True):
    """The paths', const's and res' gradients bit for bit (or within the
    same allowance as the sums where not ``exact``); the gates' and biases'
    within ``SUM_RTOL`` of their largest element."""
    for k, want in plain.items():
        got = fused[k]
        if k in PATHS + ("res", "const") and exact:
            assert torch.equal(got, want), k
        else:
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= SUM_RTOL * scale + 1e-30, k


# -----------------------------------------------------------------------------
# The plain version against the literal composition
# -----------------------------------------------------------------------------

CASES = [
    dict(gates="vector", dropout=True),
    dict(gates="vector", dropout=False),
    dict(gates="scalar", dropout=True),
    dict(gates="scalar", dropout=False),
    dict(gates="vector", dropout=True, gather=[4, 0, 7, 4, 2, 9]),
    dict(gates="vector", dropout=True, shape=(2, 3, 5)),
    dict(gates="scalar", dropout=False, shape=(2, 3, 5)),
]
IDS = ["vector-drop", "vector", "scalar-drop", "scalar", "gathered", "rg-drop", "rg-scalar"]


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_plain_version_is_the_literal_composition(kw):
    a = make_case(dtype=torch.float32, **kw)
    b = make_case(dtype=torch.float32, **kw)
    out_a, g_a, _ = grads(ek.tail_plain, a)
    out_b, g_b, _ = grads(literal, b)
    assert torch.equal(out_a, out_b)
    for k in g_a:
        assert torch.equal(g_a[k], g_b[k]), k


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_plain_version_gradcheck(kw):
    case = make_case(**kw)
    names = list(case.leaves)

    def fn(*leaves):
        lv = dict(zip(names, leaves))
        gs, const = _rebuild(lv, kw)
        return ek.tail_plain(*[lv[k] for k in PATHS + BIASES], gs, const, lv["res"], SLOPE,
                             case.keep, case.u)

    assert torch.autograd.gradcheck(fn, [case.leaves[k] for k in names], eps=1e-6, atol=1e-6)


def _rebuild(leaves: dict, kw: dict):
    """The gates and constant as ``make_case(**kw)`` forms them, from ``leaves``."""
    gs = tuple(leaves[k] for k in GATES)
    const = leaves["const"]
    gather = kw.get("gather")
    if gather is not None:
        idx = torch.as_tensor(gather)
        gs = tuple(g[idx] if g.dim() == 2 else g for g in gs)
        const = const[idx]
    shape = kw.get("shape", (6, 5))
    if len(shape) == 3 and kw["gates"] == "vector":
        gs = tuple(g.reshape(shape[:2] + (1,)) for g in gs)
    return gs, const


# -----------------------------------------------------------------------------
# The fused op, through the kernels' plain versions
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_fused_op_matches_the_plain_chain(card_stand_in, kw):
    a = make_case(dtype=torch.float32, **kw)
    b = make_case(dtype=torch.float32, **kw)
    assert ek.engages(*a.args(), a.u)
    out_f, g_f, _ = grads(ek.layer_tail, a)
    assert ek.launch_counts()["layer_tail"] == {"fwd": 1, "bwd": 1}
    out_p, g_p, _ = grads(ek.tail_plain, b)
    assert torch.equal(out_f, out_p)
    assert_routes_agree(g_p, g_f)


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_fused_op_gradcheck(card_stand_in, kw):
    """The op's backward (the backward kernel's arithmetic) against finite
    differences, in float64 (which the engage rule leaves to the plain
    version: the op is called directly on flat operands)."""
    case = make_case(**kw)
    shape = case.leaves["pi"].shape
    f = shape[-1]
    rows = int(np.prod(shape[:-1]))
    names = list(case.leaves)
    u = case.u.reshape(rows, f) if case.u is not None else None

    def fn(*leaves):
        lv = dict(zip(names, leaves))
        gs, const = _rebuild(lv, kw)
        flat = [lv[k].reshape(rows, f) for k in PATHS]
        return ek._LayerTail.apply(*flat, *[lv[k] for k in BIASES],
                                   *[g.reshape(-1) for g in gs], const.reshape(rows, f),
                                   lv["res"].reshape(rows, f), SLOPE, case.keep, u)

    assert torch.autograd.gradcheck(fn, [case.leaves[k] for k in names], eps=1e-6, atol=1e-6)


def test_leaky_kink_takes_torchs_branch(card_stand_in):
    """Where s is exactly 0, leaky ReLU's gradient is slope * g, as torch's
    ``leaky_relu_backward`` takes it (``s > 0`` false), on both routes."""
    cases = [make_case(dtype=torch.float32, seed=3) for _ in range(2)]
    for c in cases:
        with torch.no_grad():
            for k in PATHS + ("res",):
                c.leaves[k][0] = 0.0
            for k in BIASES:
                c.leaves[k].zero_()
            c.leaves["const"][0] = 0.0
    out_f, g_f, dout = grads(ek.layer_tail, cases[0])
    out_p, g_p, _ = grads(ek.tail_plain, cases[1])
    assert torch.equal(out_f, out_p) and bool((out_f[0] == 0).all())
    kept = cases[0].u[0] < cases[0].keep
    want = torch.where(kept, dout[0] / cases[0].keep * SLOPE, torch.zeros(()))
    assert torch.equal(g_f["res"][0], want) and torch.equal(g_p["res"][0], want)
    assert_routes_agree(g_p, g_f)


def test_non_power_of_two_keep_rounds_as_the_cards_division(card_stand_in):
    """``inverse_keep``: ATen divides a float32 tensor by a scalar on the
    card as a product with 1 / keep in float32; the CPU divides.  Outputs
    within two float32 roundings of the chain's."""
    a, b = (make_case(dtype=torch.float32, keep=0.7, seed=5) for _ in range(2))
    out_f, g_f, _ = grads(ek.layer_tail, a)
    out_p, g_p, _ = grads(ek.tail_plain, b)
    torch.testing.assert_close(out_f, out_p, rtol=2 ** -22, atol=0)
    assert_routes_agree(g_p, g_f, exact=False)
    assert ek.inverse_keep(0.7) == float(np.float32(1.0) / np.float32(0.7))


def test_no_grad_pass_launches_the_forward_alone(card_stand_in):
    case = make_case(dtype=torch.float32)
    with torch.no_grad():
        out = ek.layer_tail(*case.args(), SLOPE, case.keep, case.u)
    assert ek.launch_counts()["layer_tail"] == {"fwd": 1, "bwd": 0}
    assert torch.equal(out, ek.tail_plain(*case.args(), SLOPE, case.keep, case.u).detach())


def test_kernel_plain_versions_give_the_code_and_the_sums():
    case = make_case(dtype=torch.float64, gates="vector", dropout=True)
    lv = case.leaves
    with torch.no_grad():
        gs = [g.reshape(-1) for g in case.gates]
        out, code = ek.forward_plain(*[lv[k] for k in PATHS + BIASES], gs, case.const,
                                     lv["res"], SLOPE, case.keep, case.u)
        s = ek.combine_plain(case.gates, lv["pi"] + lv["b_in"], lv["po"] + lv["b_out"],
                             lv["pu"] + lv["b_und"], case.const) + lv["res"]
        assert torch.equal(code & 1, (s > 0).to(torch.uint8))
        assert torch.equal(code >> 1, (case.u < case.keep).to(torch.uint8))
        dout = torch.ones_like(out)
        d = ek.backward_plain(dout, code, *[lv[k] for k in PATHS + BIASES], gs, SLOPE,
                              ek.inverse_keep(case.keep))
    assert d[4].shape == (5, 6) and d[5].shape == (3, 5)
    torch.testing.assert_close(d[5][0], d[0].sum(0))


# -----------------------------------------------------------------------------
# The engage rule and the launch geometry
# -----------------------------------------------------------------------------


def test_engage_rule(monkeypatch):
    case = make_case(dtype=torch.float32)
    args = case.args()
    assert not ek.engages(*args, case.u)  # CPU tensors
    monkeypatch.setattr(ek, "_on_card", lambda t: True)
    assert ek.engages(*args, case.u) and ek.engages(*args, None)
    rg = make_case(dtype=torch.float32, shape=(2, 3, 5))
    assert ek.engages(*rg.args(), rg.u)
    scalar = make_case(dtype=torch.float32, gates="scalar")
    assert ek.engages(*scalar.args(), scalar.u)
    bf16 = [a.to(torch.bfloat16) if isinstance(a, torch.Tensor) else a for a in args]
    assert not ek.engages(*bf16[:6], tuple(g.to(torch.bfloat16) for g in case.gates),
                          *bf16[7:], case.u)
    assert not ek.engages(*args[:7], 0.0, args[8], case.u)  # no constant
    # A packed rg carry: 128-wide rows of k nodes, the gates one a node.
    packed = make_case(dtype=torch.float32, shape=(2, 3, 128))
    gates = tuple(g.reshape(-1, 1).repeat(4, 1)[:6 * 4] for g in packed.gates)
    assert not ek.engages(*packed.args()[:6], gates, *packed.args()[7:], packed.u)
    wide = make_case(dtype=torch.float32, shape=(2, 1028))
    assert not ek.engages(*wide.args(), wide.u)
    strided = [a.t().contiguous().t() if isinstance(a, torch.Tensor) and a.dim() == 2
               and a.shape[1] == 5 else a for a in args]
    assert not ek.engages(*strided, case.u)


@pytest.mark.parametrize("f,aligned,want", [
    (256, True, (4, 32, 2)), (128, True, (4, 32, 1)), (64, True, (4, 16, 1)),
    (37, True, (1, 32, 2)), (3, True, (1, 4, 1)), (1, True, (1, 1, 1)),
    (1024, True, (4, 32, 8)), (256, False, (1, 32, 8)), (1025, True, None),
    (300, False, None)])
def test_launch_plan(f, aligned, want):
    plan = ek.launch_plan(f, aligned)
    assert (tuple(plan) if plan is not None else None) == want
    if plan is not None:  # every column has a lane, within the backward's registers
        assert plan.lanes * plan.chunks * plan.vec >= f and plan.chunks <= ek.MAX_CHUNKS
        assert plan.lanes * (plan.chunks // 2) * plan.vec < f or plan.chunks == 1


# -----------------------------------------------------------------------------
# The model and the trainer
# -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    return NgramGraphBuilder(n_max=3).build_from_sequences(SEQS)


class OneShard:
    """A feature axis of one shard: the gather and the sum are identities."""

    shards, rank = 1, 0

    def cols(self, width):
        return slice(0, width)

    def gather(self, t):
        return t

    def sum(self, t):
        return t


def _model_run(graphs, kind, vec, permute=False, feat=False, remat_paths=False):
    dev = graphs[2].to_device(mode=kind, device="cpu")
    if feat:
        dev = dataclasses.replace(dev, feat=OneShard())
    n = dev.num_nodes
    cfg = t_model.DirectGCNConfig(layer_dims=(10, 8, 8, 6), num_nodes=n, num_classes=5,
                                  n_gram_len=3, dropout=0.5, decoder_dropout=0.0,
                                  use_vector_coeffs=vec, remat_paths=remat_paths)
    p = t_model.init_directgcn_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    for leaf in t_model.param_leaves(p):
        leaf.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(n, 10)).astype(np.float32))
    if kind == "hypercube" and not permute:
        x = x.reshape(dev.p_in.feature_shape + (10,))
    oi = torch.from_numpy(np.random.default_rng(2).permutation(n)) if permute else None
    ls, emb = t_model.directgcn_apply(p, dev, x, cfg, train=True,
                                      gen=torch.Generator().manual_seed(5), original_indices=oi)
    leaves = t_model.param_leaves(p)
    gs = torch.autograd.grad(ls.sum() + emb.sum(), leaves, allow_unused=True)
    return ls.detach(), emb.detach(), gs


@pytest.mark.parametrize("kind,vec,permute", [
    ("hypercube", True, False), ("hypercube", False, False), ("ell", True, False),
    ("dense", False, False), ("ell", True, True)],
    ids=["hyper", "hyper-scalar", "ell", "dense-scalar", "ell-gathered"])
def test_model_on_the_fused_op_matches_the_plain_route(monkeypatch, graphs, kind, vec, permute):
    want = _model_run(graphs, kind, vec, permute)
    monkeypatch.setattr(ek, "_on_card", lambda t: True)
    ek.reset_launches()
    got = _model_run(graphs, kind, vec, permute)
    assert ek.launch_counts()["layer_tail"] == {"fwd": 3, "bwd": 3}  # one each a layer
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("feat,remat_paths", [(True, False), (False, True)],
                         ids=["feature-shard", "packed-rg"])
def test_feature_shards_and_packed_carries_keep_the_plain_chain(monkeypatch, graphs, feat,
                                                                 remat_paths):
    monkeypatch.setattr(ek, "_on_card", lambda t: True)
    ek.reset_launches()
    _model_run(graphs, "hypercube" if remat_paths else "ell", True, feat=feat,
               remat_paths=remat_paths)
    assert ek.launch_counts()["layer_tail"] == {"fwd": 0, "bwd": 0}


def _train(graphs, kind, plan_edit=None, **overrides):
    cfg = Config()
    cfg.apply_overrides({"gcn.hidden_layer_dims": [8, 6], "gcn.epochs_per_level": 2,
                         "gcn.use_early_stopping": False, "gcn.spmm_mode": kind,
                         "gcn.use_cluster_training": False,
                         **{f"gcn.{k}": v for k, v in overrides.items()}})
    tt = t_trainer.HierarchicalTrainer(cfg, device="cpu")
    if plan_edit is not None:
        level_plan = tt._level_plan
        tt._level_plan = lambda *a, **k: dataclasses.replace(level_plan(*a, **k), **plan_edit)
    graph = graphs[2]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(graph.num_nodes, 6)).astype(np.float32)
    y = rng.integers(0, 4, graph.num_nodes).astype(np.int64)
    tt.train_level(graph, x, y, 4)
    return tt.level_stats[3]


@pytest.mark.parametrize("route,kind,plan_edit,overrides", [
    ("cpu", "hypercube", None, {}),
    ("fused", "hypercube", None, {}),
    ("fused", "ell", None, {}),
    ("bf16", "ell", None, {"compute_dtype": "bfloat16"}),
    ("packed-rg", "hypercube", {"remat_paths": True}, {}),
])
def test_level_stats_record_the_tail_route(monkeypatch, graphs, route, kind, plan_edit,
                                           overrides):
    if route != "cpu":
        monkeypatch.setattr(ek, "_on_card", lambda t: True)
    st = _train(graphs, kind, plan_edit, **overrides)
    layers, steps = 2, st["steps"]
    if route == "fused":
        assert st["epilogue"] == {"route": "fused", "launches": 2 * layers * steps}
    else:
        assert st["epilogue"] == {"route": "plain", "launches": 0}


# -----------------------------------------------------------------------------
# On the card
# -----------------------------------------------------------------------------

# The benchmark cells' layer outputs: N rows as the hypercube's rg carry or
# the vocabulary's flat one, at each hidden width.
CARD_SHAPES = [(21, 9261, f) for f in (256, 128, 64)] + [(167_325, f) for f in (256, 128, 64)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ek.build()
    return torch.device("cuda", 0)


@pytest.mark.chip
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dropout,keep", [(True, 0.5), (False, 0.5), (True, 0.7)],
                         ids=["drop", "nodrop", "keep0.7"])
def test_kernels_match_the_plain_chain_at_the_cells_shapes(cuda_device, shape, dropout, keep):
    kw = dict(shape=shape, dropout=dropout, keep=keep, dtype=torch.float32, device=cuda_device,
              seed=11)
    a, b = make_case(**kw), make_case(**kw)
    assert ek.engages(*a.args(), a.u)
    ek.reset_launches()
    out_f, g_f, _ = grads(ek.layer_tail, a)
    assert ek.launch_counts()["layer_tail"] == {"fwd": 1, "bwd": 1}
    out_p, g_p, _ = grads(ek.tail_plain, b)
    torch.cuda.synchronize()
    assert torch.equal(out_f, out_p)
    assert_routes_agree(g_p, g_f)


@pytest.mark.chip
@pytest.mark.parametrize("gates", ["scalar", "gathered"])
def test_kernels_take_scalar_and_gathered_gates(cuda_device, gates):
    kw = dict(shape=(5003, 64), dtype=torch.float32, device=cuda_device, seed=4,
              gates="scalar" if gates == "scalar" else "vector",
              gather=(np.random.default_rng(0).integers(0, 8000, 5003)
                      if gates == "gathered" else None))
    a, b = make_case(**kw), make_case(**kw)
    out_f, g_f, _ = grads(ek.layer_tail, a)
    out_p, g_p, _ = grads(ek.tail_plain, b)
    assert torch.equal(out_f, out_p)
    assert_routes_agree(g_p, g_f)


@pytest.mark.chip
def test_two_launches_a_layer_a_step(cuda_device, graphs):
    cfg = Config()
    cfg.apply_overrides({"gcn.hidden_layer_dims": [16, 8, 8], "gcn.epochs_per_level": 3,
                         "gcn.use_early_stopping": False, "gcn.spmm_mode": "hypercube",
                         "gcn.use_cluster_training": False})
    tt = t_trainer.HierarchicalTrainer(cfg, device=cuda_device)
    graph = graphs[2]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(graph.num_nodes, 6)).astype(np.float32)
    y = rng.integers(0, 4, graph.num_nodes).astype(np.int64)
    tt.train_level(graph, x, y, 4)
    st = tt.level_stats[3]
    assert st["epilogue"] == {"route": "fused", "launches": 2 * 3 * st["steps"]}
