"""Port parity: the ELL, bucketed ELL and COO formats and the ELL kernels.

The same seeded numpy inputs go through the JAX package and the port:

- builders (``build_ell``, ``build_bucketed_ell``, ``build_coo``) byte for
  byte, on random graphs and on real n = 2 and n = 3 n-gram matrices; the
  ``choose_format`` and ``build_adjacency(mode="auto")`` decisions, the
  block format's factors field for field where the JAX package picks it;
- the ELL kernels' plain versions against the Pallas kernels run with
  ``interpret=True`` (as tests/test_pallas.py runs them), rtol 1e-5 and
  atol 1e-6 * max|x| * K: float32 sums of K products taken in another order;
- ``propagate`` forward and x-gradient against ``jax.vjp`` of the JAX
  package's ``propagate`` (the XLA custom VJPs: its Pallas path runs only
  on a TPU), rtol 1e-5, atol 1e-6;
- the model's forward and every parameter gradient on ELL operators
  (through the kernels' entry points), at the tolerances of
  tests/test_torch_model.py.

On the CPU the wrappers run the plain versions and count nothing; the CUDA
branch is driven with a stand-in library to show it counts one per launch,
and ``propagate``'s card branch (``spmm._on_card`` made true; on the CPU
the wrappers' plain versions compute there) with recording wrappers to show
that ELL and bucketed ELL operators reach the kernels in both directions,
never the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.graph import transforms as t_transforms
from protgram_directgcn_torch.models import directgcn as t_model
from protgram_directgcn_torch.ops import _nvcc
from protgram_directgcn_torch.ops import block as t_block
from protgram_directgcn_torch.ops import ell_kernels as ek
from protgram_directgcn_torch.ops import spmm as t_spmm
from protgram_directgcn_tpu.graph import transforms as j_transforms
from protgram_directgcn_tpu.models import directgcn as j_model
from protgram_directgcn_tpu.ops import block as j_block
from protgram_directgcn_tpu.ops import spmm as j_spmm
from protgram_directgcn_tpu.ops.pallas_spmm import _ell_hbm_raw, _ell_pallas_raw
from tests.test_torch_graph import _both_graphs, write_seeded_fasta

MATRICES = ("mathcal_a_in", "mathcal_a_out", "undirected_norm")


def _random_edges(seed, n_out, n_in, e, kind="uniform"):
    """Unique weighted edges src < n_in -> tgt < n_out: uniform; "hub" points
    a third of them at target 0 (degree skew); "regular" gives every target
    e // n_out sources (bounded degree)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_in, e)
    tgt = rng.integers(0, n_out, e)
    if kind == "hub":
        tgt[: e // 3] = 0
    elif kind == "regular":
        tgt = np.repeat(np.arange(n_out), e // n_out)
        src = rng.permutation(tgt)
    pairs = np.unique(np.stack([src, tgt], 1), axis=0)
    w = rng.uniform(0.1, 2.0, len(pairs)).astype(np.float32)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32), w


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_adj(t, j):
    """Every array of a port adjacency equals the JAX one's, byte for byte."""
    if isinstance(j, j_spmm.EllAdj):
        for k in ("idx", "w", "idx_t", "w_t"):
            _same(getattr(t, k).numpy(), getattr(j, k))
    elif isinstance(j, j_block.BlockNgramAdj):
        for k in ("d", "wf", "wb", "sgrp", "pgrp", "pos_p", "pos_s"):
            _same(getattr(t, k).numpy(), getattr(j, k))
    elif isinstance(j, j_spmm.BucketedEllAdj):
        for k in ("idx", "w", "idx_t", "w_t"):
            tb, jb = getattr(t, k), getattr(j, k)
            assert len(tb) == len(jb)
            for a, b in zip(tb, jb):
                _same(a.numpy(), b)
        _same(t.inv_perm.numpy(), j.inv_perm)
        _same(t.inv_perm_t.numpy(), j.inv_perm_t)
    else:
        for k in ("src", "tgt", "w", "src_t", "tgt_t", "w_t"):
            _same(getattr(t, k).numpy(), getattr(j, k))
        assert (t.n_out, t.n_in) == (j.n_out, j.n_in)


RANDOM_CASES = [  # (seed, n_out, n_in, edges, kind)
    (0, 137, 137, 600, "uniform"), (1, 137, 90, 400, "uniform"), (2, 50, 300, 700, "hub"),
    (3, 300, 300, 2000, "hub"), (4, 40, 40, 0, "uniform"), (5, 1, 7, 5, "uniform"),
    (6, 3000, 3000, 48_000, "regular"), (7, 5000, 5000, 2000, "uniform"),
]
BUILDERS = ["build_ell", "build_bucketed_ell", "build_coo"]


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("case", RANDOM_CASES, ids=lambda c: f"s{c[0]}")
def test_builders_match_jax_on_random_graphs(builder, case):
    seed, n_out, n_in, e, kind = case
    src, tgt, w = _random_edges(seed, n_out, n_in, e, kind)
    j = getattr(j_spmm, builder)(src, tgt, w, n_out, n_in)
    _same_adj(getattr(t_spmm, builder)(src, tgt, w, n_out, n_in, device="cpu"), j)
    _same_adj(convert.ell_from_jax(j, device="cpu"), j)


@pytest.fixture(scope="module")
def ngram_graphs(tmp_path_factory):
    fasta = write_seeded_fasta(tmp_path_factory.mktemp("ell") / "seq.fasta", n_seqs=40,
                               lo=30, hi=120)
    return _both_graphs(fasta)


def _coo(graph, matrix, transforms):
    return transforms.csr_to_coo_arrays(getattr(graph, matrix)())


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("matrix", MATRICES)
@pytest.mark.parametrize("level", [2, 3])
def test_builders_match_jax_on_ngram_graphs(ngram_graphs, builder, matrix, level):
    jg, tg = ngram_graphs
    j_args = _coo(jg[level - 1], matrix, j_transforms)
    t_args = _coo(tg[level - 1], matrix, t_transforms)
    for a, b in zip(t_args, j_args):
        _same(a, b)
    n = tg[level - 1].num_nodes
    _same_adj(getattr(t_spmm, builder)(*t_args, n, device="cpu"),
              getattr(j_spmm, builder)(*j_args, n))


@pytest.mark.parametrize("feat_dim", [1, 16, 128, 512])
def test_choose_format_matches_jax(feat_dim):
    for n_out in (1, 10, 300, 2_000, 40_000):
        for n_in in (n_out, 7, 50_000):
            for nnz in (0, 1, n_out // 2, 3 * n_out, 40 * n_out):
                assert (t_spmm.choose_format(n_out, n_in, nnz, feat_dim)
                        == j_spmm.choose_format(n_out, n_in, nnz, feat_dim))


_KIND = {j_spmm.DenseAdj: "dense", j_spmm.EllAdj: "ell", j_spmm.BucketedEllAdj: "bucketed",
         j_spmm.CooAdj: "coo", j_block.BlockNgramAdj: "block"}
_T_KIND = {t_spmm.DenseAdj: "dense", t_spmm.EllAdj: "ell", t_spmm.BucketedEllAdj: "bucketed",
           t_spmm.CooAdj: "coo", t_block.BlockNgramAdj: "block"}


def _auto_kinds(src, tgt, w, n_out, n_in, feat_dim, node_keys=None):
    j = j_spmm.build_adjacency(src, tgt, w, n_out, n_in, mode="auto", feat_dim=feat_dim,
                               node_keys=node_keys)
    kind = _KIND[type(j)]
    t = t_spmm.build_adjacency(src, tgt, w, n_out, n_in, mode="auto", feat_dim=feat_dim,
                               node_keys=node_keys, device="cpu")
    if kind != "dense":
        _same_adj(t, j)
    return _T_KIND[type(t)], kind


@pytest.mark.parametrize("feat_dim", [1, 16, 128])
@pytest.mark.parametrize("case", RANDOM_CASES, ids=lambda c: f"s{c[0]}")
def test_auto_format_matches_jax_on_random_graphs(case, feat_dim):
    seed, n_out, n_in, e, kind = case
    got, want = _auto_kinds(*_random_edges(seed, n_out, n_in, e, kind), n_out, n_in, feat_dim)
    assert got == want


@pytest.mark.parametrize("feat_dim", [4, 64, 256])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_auto_format_matches_jax_on_ngram_graphs(ngram_graphs, level, feat_dim):
    """With the n-gram node keys the JAX package may pick the block format,
    and the port builds the same factors."""
    jg, tg = ngram_graphs
    g = tg[level - 1]
    keys = t_block.ngram_node_keys(g.vocab) if level >= 2 else None
    if keys is not None:
        for a, b in zip(keys, j_block.ngram_node_keys(jg[level - 1].vocab)):
            np.testing.assert_array_equal(a, b)
    seen = set()
    for matrix in MATRICES:
        got, want = _auto_kinds(*_coo(g, matrix, t_transforms), g.num_nodes, g.num_nodes,
                                feat_dim, keys)
        assert got == want
        seen.add(want)
    assert seen


def test_block_selection_rule_matches_jax_when_the_structure_breaks():
    """An edge outside both n-gram patterns makes both block builders
    raise, and auto then falls through to ELL in both packages; forcing
    ``mode="block"`` raises in both."""
    vocab = np.array(["AA", "AB", "BA", "BB"])
    pk, sk, nk = t_block.ngram_node_keys(vocab)
    src = np.array([0, 1, 2, 3, 0, 1, 2, 3, 1], np.int32)
    tgt = np.array([1, 2, 3, 0, 0, 1, 2, 3, 0], np.int32)  # 3 -> 0 ("BB" -> "AA") is off-pattern
    w = np.ones(len(src), np.float32)
    with pytest.raises(t_block.BlockStructureError):
        t_block.build_block_ngram(src, tgt, w, 4, pk, sk, nk, device="cpu")
    with pytest.raises(j_block.BlockStructureError):
        j_block.build_block_ngram(src, tgt, w, 4, pk, sk, nk)
    got, want = _auto_kinds(src, tgt, w, 4, 4, 4096, (pk, sk, nk))
    assert got == want
    with pytest.raises(t_block.BlockStructureError):
        t_spmm.build_adjacency(src, tgt, w, 4, mode="block", node_keys=(pk, sk, nk),
                               device="cpu")


# -----------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels (interpret mode)
# -----------------------------------------------------------------------------


def _ell_case(f, seed=11, n_out=137, n_in=90):
    src, tgt, w = _random_edges(seed, n_out, n_in, 4 * n_out)
    adj = j_spmm.build_ell(src, tgt, w, n_out, n_in)
    x = np.random.default_rng(seed + f).normal(size=(n_in, f)).astype(np.float32)
    return adj, x


@pytest.mark.parametrize("f", [1, 32, 64, 200])
@pytest.mark.parametrize("kernel", ["ell_resident", "ell_hbm"])
def test_plain_matches_pallas_interpret(kernel, f):
    adj, x = _ell_case(f)
    raw = _ell_pallas_raw if kernel == "ell_resident" else _ell_hbm_raw
    ref = np.asarray(raw(adj.idx, adj.w, jnp.asarray(x), interpret=True))
    plain = getattr(ek, f"{kernel}_plain")
    idx, w = torch.from_numpy(np.array(adj.idx)), torch.from_numpy(np.array(adj.w))
    got = plain(idx, w, torch.from_numpy(x)).numpy()
    k = idx.shape[1]
    assert got.shape == ref.shape == (137, f)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(x).max() * k)
    # The wrapper on CPU tensors is the plain version.
    np.testing.assert_array_equal(getattr(ek, kernel)(idx, w, torch.from_numpy(x)).numpy(), got)


def test_resident_rule_matches_pallas_supported():
    from protgram_directgcn_tpu.ops.pallas_spmm import pallas_supported

    for n_in in (0, 1, 9_261, 16_383, 16_384, 16_385, 194_481):
        assert ek.resident_supported(n_in) == pallas_supported(n_in)


@pytest.mark.parametrize("n_out,n_in,expect", [
    (10, 16_384, "ell_resident"), (10, 16_385, "ell_hbm"), (16_385, 10, "ell_resident"),
])
def test_dispatch_reads_n_in_from_the_transpose(monkeypatch, n_out, n_in, expect):
    """propagate_ell_pallas picks by adj.idx_t.shape[0], and the backward
    runs the forward's kernel on (idx_t, w_t)."""
    calls = []

    def recorder(name):
        def kernel(idx, w, x, direction="fwd"):
            calls.append((name, direction, tuple(idx.shape)))
            return ek.ell_plain(idx, w, x)
        return kernel

    monkeypatch.setattr(ek, "ell_resident", recorder("ell_resident"))
    monkeypatch.setattr(ek, "ell_hbm", recorder("ell_hbm"))
    src, tgt, w = _random_edges(3, n_out, n_in, 50)
    adj = t_spmm.build_ell(src, tgt, w, n_out, n_in, device="cpu")
    monkeypatch.setattr(t_spmm, "_on_card", lambda t: True)
    x = torch.ones(n_in, 1, requires_grad=True)
    t_spmm.propagate(adj, x).sum().backward()
    assert calls == [(expect, "fwd", tuple(adj.idx.shape)),
                     (expect, "bwd", tuple(adj.idx_t.shape))]


def _recorders(monkeypatch, calls):
    """Replace both kernel wrappers with recorders that compute the plain
    version, and make the plain version itself refuse to run: on the CUDA
    branch the product must reach it only through a kernel wrapper."""
    plain = ek.ell_plain

    def recorder(name):
        def kernel(idx, w, x, direction="fwd"):
            assert x.dtype == torch.float32 and x.is_contiguous()
            calls.append((name, direction, tuple(idx.shape)))
            return plain(idx, w, x)
        return kernel

    def refuse(*args):
        raise AssertionError("the plain ELL version ran on the CUDA branch")

    monkeypatch.setattr(ek, "ell_resident", recorder("ell_resident"))
    monkeypatch.setattr(ek, "ell_hbm", recorder("ell_hbm"))
    monkeypatch.setattr(ek, "ell_plain", refuse)


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("fmt", ["build_ell", "build_bucketed_ell"])
@pytest.mark.parametrize("n_out,n_in,expect", [
    (10, 16_384, "ell_resident"), (10, 16_385, "ell_hbm"), (16_385, 10, "ell_resident"),
])
def test_cuda_branch_routes_ell_formats_through_the_kernels(monkeypatch, fmt, layout,
                                                            n_out, n_in, expect):
    """On the card an ``EllAdj`` and each bucket of a ``BucketedEllAdj`` run
    the kernel of their regime (picked by n_in, as propagate_ell_pallas
    does), forward and, on the stored transpose, backward, on a contiguous
    f32 copy of a strided x; the values and gradient are the plain
    route's."""
    src, tgt, w = _random_edges(3, n_out, n_in, 50, "hub")
    adj = getattr(t_spmm, fmt)(src, tgt, w, n_out, n_in, device="cpu")
    rng = np.random.default_rng(n_in)
    x = rng.normal(size=(n_in, 6)).astype(np.float32)
    cot = torch.from_numpy(rng.normal(size=(n_out, 6)).astype(np.float32))
    x_ref = torch.from_numpy(x).requires_grad_(True)
    y_ref = t_spmm.propagate(adj, x_ref)  # the plain route (CPU tensors)
    y_ref.backward(cot)

    calls = []
    _recorders(monkeypatch, calls)
    monkeypatch.setattr(t_spmm, "_on_card", lambda t: True)
    xt = (torch.from_numpy(x) if layout == "contiguous"
          else torch.from_numpy(np.ascontiguousarray(x.T)).T).requires_grad_(True)
    assert xt.is_contiguous() == (layout == "contiguous")
    y = t_spmm.propagate(adj, xt)
    y.backward(cot)
    if fmt == "build_ell":
        want = [(expect, "fwd", tuple(adj.idx.shape)), (expect, "bwd", tuple(adj.idx_t.shape))]
    else:
        want = ([(expect, "fwd", tuple(i.shape)) for i in adj.idx]
                + [(expect, "bwd", tuple(i.shape)) for i in adj.idx_t])
    assert calls == want
    np.testing.assert_array_equal(y.detach().numpy(), y_ref.detach().numpy())
    np.testing.assert_array_equal(xt.grad.numpy(), x_ref.grad.numpy())
    calls.clear()
    tr = t_spmm.propagate_transpose(adj, cot)
    assert [c[1] for c in calls] == ["fwd"] * (len(want) // 2)
    np.testing.assert_array_equal(tr.numpy(), x_ref.grad.numpy())


def test_bucketed_kernel_route_matches_jax(monkeypatch):
    """The bucketed operator through the kernels' route (plain versions
    behind the wrappers on the CPU) against the JAX package's propagate."""
    src, tgt, w = _random_edges(2, 50, 300, 700, "hub")
    j = j_spmm.build_bucketed_ell(src, tgt, w, 50, 300)
    t = t_spmm.build_bucketed_ell(src, tgt, w, 50, 300, device="cpu")
    assert len(t.idx) > 1
    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 24)).astype(np.float32)
    cot = rng.normal(size=(50, 24)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda v: j_spmm.propagate(j, v), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(cot))
    monkeypatch.setattr(t_spmm, "_on_card", lambda t: True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = t_spmm.propagate(t, xt)
    out_t.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt", ["build_ell", "build_bucketed_ell"])
def test_cuda_branch_has_no_fallback(monkeypatch, fmt):
    """A kernel that fails on the card raises through propagate: the plain
    version does not stand in."""
    src, tgt, w = _random_edges(4, 30, 30, 90)
    adj = getattr(t_spmm, fmt)(src, tgt, w, 30, device="cpu")
    _recorders(monkeypatch, [])

    def broken(idx, w, x, direction="fwd"):
        raise RuntimeError("ell_resident launch failed: CUDA error 9")

    monkeypatch.setattr(ek, "ell_resident", broken)
    monkeypatch.setattr(t_spmm, "_on_card", lambda t: True)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        t_spmm.propagate(adj, torch.ones(30, 4))


def test_on_card_reads_the_device():
    assert not t_spmm._on_card(torch.zeros(2))
    assert not t_spmm._on_card(torch.zeros(2, device="meta"))


class _FakeLib:
    """Stands in for the nvcc-built library: records calls, returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args[4:7]))
            return self.rc
        return fn


def test_cuda_branch_counts_one_per_launch(monkeypatch):
    fake = _FakeLib()
    monkeypatch.setattr(ek, "_lib", fake)
    monkeypatch.setattr(_nvcc, "stream_ptr", lambda t: 0)
    ek.reset_launches()
    idx = torch.zeros(5, 4, dtype=torch.int32)
    w = torch.zeros(5, 4)
    x = torch.zeros(3, 8)
    ek._launch_cuda("ell_resident", idx, w, x, "fwd")
    ek._launch_cuda("ell_hbm", idx, w, x, "bwd")
    ek._launch_cuda("ell_hbm", idx, w, x, "bwd")
    ek._launch_cuda("ell_hbm", idx[:0], w[:0], x, "fwd")  # empty output: no launch
    assert ek.launch_counts() == {"ell_resident": {"fwd": 1, "bwd": 0},
                                  "ell_hbm": {"fwd": 0, "bwd": 2}}
    assert fake.calls == [("ell_resident_f32", (5, 4, 8))] + [("ell_hbm_f32", (5, 4, 8))] * 2
    monkeypatch.setattr(ek, "_lib", _FakeLib(rc=9))
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        ek._launch_cuda("ell_hbm", idx, w, x, "fwd")
    assert ek.launch_counts()["ell_hbm"]["fwd"] == 0
    ek.reset_launches()


def test_wrappers_refuse_what_the_kernel_cannot_take():
    idx = torch.zeros(5, 4, dtype=torch.int32)
    w = torch.zeros(5, 4)
    x = torch.zeros(3, 8)
    with pytest.raises(TypeError):
        ek.ell_resident(idx.long(), w, x)
    with pytest.raises(TypeError):
        ek.ell_hbm(idx, w, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ek.ell_hbm(idx, w, torch.zeros(8, 3).T)
    with pytest.raises(ValueError, match="shape"):
        ek.ell_resident(idx, w[:, :3], x)
    meta = [t.to("meta") for t in (idx, w, x)]
    for fn in (ek.ell_resident, ek.ell_hbm):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*meta)


# -----------------------------------------------------------------------------
# Autograd: propagate / propagate_transpose / propagate_affine
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,route", [
    ("build_ell", "card"), ("build_ell", "plain"), ("build_bucketed_ell", "plain"),
    ("build_coo", "plain"),
])
@pytest.mark.parametrize("case", RANDOM_CASES[:4], ids=lambda c: f"s{c[0]}")
def test_propagate_and_gradient_match_jax(monkeypatch, case, fmt, route):
    """"card": ``spmm._on_card`` made true, so the ELL operator goes through
    the kernels' entry points (their plain versions on the CPU)."""
    seed, n_out, n_in, e, kind = case
    src, tgt, w = _random_edges(seed, n_out, n_in, e, kind)
    j = getattr(j_spmm, fmt)(src, tgt, w, n_out, n_in)
    t = getattr(t_spmm, fmt)(src, tgt, w, n_out, n_in, device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_in, 24)).astype(np.float32)
    cot = rng.normal(size=(n_out, 24)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda v: j_spmm.propagate(j, v), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(cot))
    if route == "card":
        monkeypatch.setattr(t_spmm, "_on_card", lambda t: True)
    xt = torch.from_numpy(x).requires_grad_(True)
    ek.reset_launches()
    out_t = t_spmm.propagate(t, xt)
    out_t.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-5, atol=1e-6)
    tr_j = j_spmm.propagate_transpose(j, jnp.asarray(cot))
    tr_t = t_spmm.propagate_transpose(t, torch.from_numpy(cot))
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=1e-5, atol=1e-6)
    aff_j = j_spmm.propagate_affine(j, jnp.asarray(x), 0.7, -0.3)
    aff_t = t_spmm.propagate_affine(t, torch.from_numpy(x), 0.7, -0.3)
    np.testing.assert_allclose(aff_t.numpy(), np.asarray(aff_j), rtol=1e-5, atol=1e-6)
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert ek.launch_counts() == {"ell_resident": {"fwd": 0, "bwd": 0},
                                  "ell_hbm": {"fwd": 0, "bwd": 0}}


# -----------------------------------------------------------------------------
# The model on ELL operators
# -----------------------------------------------------------------------------


RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_model.py


def _leaves(tree, path=()):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [lp for k in sorted(tree) for lp in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [lp for i, v in enumerate(tree) for lp in _leaves(v, path + (i,))]
    return [(path, tree)]


@pytest.mark.parametrize("level", [1, 2, 3])
def test_model_forward_and_gradients_match_jax_on_ell(monkeypatch, ngram_graphs, level):
    jg, tg = ngram_graphs
    monkeypatch.setattr(t_spmm, "_on_card", lambda t: True)  # the kernels' entry points
    j_dev = jg[level - 1].to_device(mode="ell")
    t_dev = tg[level - 1].to_device(mode="pallas", device="cpu")
    assert t_dev.route == "ell"
    for a in ("p_in", "p_out", "p_und"):  # the operators as ell_from_jax carries them
        setattr(t_dev, a, convert.ell_from_jax(getattr(j_dev, a), device="cpu"))
    n = t_dev.num_nodes
    dims = (12, 8, 6)
    common = dict(layer_dims=dims, num_nodes=n, num_classes=5, n_gram_len=level,
                  one_gram_dim=dims[0] if level == 1 else 0, max_pe_len=16, dropout=0.0,
                  decoder_dropout=0.0)
    jcfg = j_model.DirectGCNConfig(**common)
    tcfg = t_model.DirectGCNConfig(**common)
    rng = np.random.default_rng(level)
    x = rng.normal(size=(n, dims[0])).astype(np.float32)
    r_ls = rng.normal(size=(n, 5)).astype(np.float32)
    r_emb = rng.normal(size=(n, dims[-1])).astype(np.float32)
    jp = j_model.init_directgcn_params(jax.random.PRNGKey(level), jcfg)

    def j_obj(p):
        ls, emb = j_model.directgcn_apply(p, j_dev, jnp.asarray(x), jcfg, train=True,
                                          rng=jax.random.PRNGKey(5))
        return jnp.sum(ls * r_ls) + jnp.sum(emb * r_emb), (ls, emb)

    (j_val, (j_ls, j_emb)), j_grads = jax.value_and_grad(j_obj, has_aux=True)(jp)
    tp = convert.params_from_jax(jp, device="cpu")
    for _, t in _leaves(tp):
        t.requires_grad_(True)
    ls, emb = t_model.directgcn_apply(tp, t_dev, torch.from_numpy(x), tcfg, train=True,
                                      gen=torch.Generator().manual_seed(5))
    np.testing.assert_allclose(ls.detach().numpy(), np.asarray(j_ls), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(j_emb), rtol=RTOL, atol=ATOL)
    t_val = torch.sum(ls * torch.from_numpy(r_ls)) + torch.sum(emb * torch.from_numpy(r_emb))
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), rtol=RTOL)
    j_leaves = dict(_leaves(j_grads))
    t_leaves = _leaves(tp)
    assert len(t_leaves) == len(j_leaves)
    for path, t in t_leaves:
        jgr = np.asarray(j_leaves[path]).reshape(tuple(t.shape))
        np.testing.assert_allclose(t.grad.numpy(), jgr, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(jgr).max())),
                                   err_msg=str(path))


def test_device_graph_routes(ngram_graphs):
    _, tg = ngram_graphs
    g = tg[2]
    for mode, route in (("dense", "dense"), ("ell", "ell"), ("pallas", "ell"),
                        ("bucketed", "bucketed"), ("coo", "coo"), ("hypercube", "hypercube")):
        assert g.to_device(mode=mode, device="cpu").route == route
