"""Port parity: SDDMM edge-weight gradients (``propagate(..., edge_grads=True)``).

Each case runs the same seeded operator and inputs through the JAX
package's ``propagate`` under ``jax.grad`` and the port's under autograd,
with loss ``sum(propagate(adj, x) * r)``: the forward weight leaves'
gradients (ELL unrolled and chunked over K, bucketed ELL per bucket, COO,
the hypercube's diagonal and both banks) and ``dx`` agree at rtol 1e-5,
atol 1e-6 x max|reference| (float32 sums in another order).  The JAX
package's "dual" (g-major K1 bank) and "pk" (packed) hypercube layouts are
mapped onto the port's "rs".  Without ``edge_grads`` the graph gets no
gradient; the deprecated ``edge_gradients()`` context warns and sets the
default; with the card's route forced the ELL products still run the ELL
kernels, never ``ell_plain``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protgram_directgcn_torch.ops import ell_kernels, spmm as t_spmm
from protgram_directgcn_torch.ops import hypercube as t_hyper
from protgram_directgcn_torch.graph.structure import DeviceGraph
from protgram_directgcn_tpu.graph import transforms as j_transforms
from protgram_directgcn_tpu.graph.builder import NgramGraphBuilder
from protgram_directgcn_tpu.ops import hypercube as j_hyper, spmm as j_spmm

RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(ref).max())), err_msg=what)


def _graph(n=40, edges=160, hub_degree=0, seed=0):
    """Unique weighted edges; ``hub_degree`` > 16 gives node 0 that many
    in-edges (K past the unrolled bound)."""
    rng = np.random.default_rng(seed)
    pairs = {(int(rng.integers(n)), int(rng.integers(n))) for _ in range(edges)}
    pairs |= {(s, 0) for s in range(1, hub_degree + 1)}
    src = np.array([p[0] for p in pairs], np.int64)
    tgt = np.array([p[1] for p in pairs], np.int64)
    return src, tgt, rng.uniform(0.2, 1.0, len(src)).astype(np.float32), n


def _inputs(n, f=12, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, f)).astype(np.float32),
            rng.normal(size=(n, f)).astype(np.float32))


def _jax_grads(adj, leaves, x, r):
    def loss(ws, xv):
        return jnp.sum(j_spmm.propagate(adj.replace(**dict(zip(leaves, ws))), xv,
                                        edge_grads=True) * r)

    return jax.grad(loss, argnums=(0, 1))(tuple(getattr(adj, k) for k in leaves),
                                         jnp.asarray(x))


def _leaf(t):
    return t.clone().requires_grad_(True)


@pytest.mark.parametrize("hub,chunk_bytes", [(0, None), (24, None), (36, 4096)],
                         ids=["unrolled", "chunked", "several_chunks"])
def test_ell_dw_matches_jax(monkeypatch, hub, chunk_bytes):
    src, tgt, w, n = _graph(hub_degree=hub)
    x, r = _inputs(n)
    if chunk_bytes is not None:  # [N, chunk, F] gathers of a few slots
        monkeypatch.setattr(j_spmm, "_ELL_CHUNK_BYTES", chunk_bytes)
        monkeypatch.setattr(t_spmm, "_ELL_CHUNK_BYTES", chunk_bytes)
    jadj = j_spmm.build_ell(src, tgt, w, n)
    assert (jadj.idx.shape[1] > t_spmm._ELL_UNROLL_K) == bool(hub)
    (jdw,), jdx = _jax_grads(jadj, ("w",), x, r)
    tadj = t_spmm.build_ell(src, tgt, w, n, device="cpu")
    tadj.w, tadj.w_t = _leaf(tadj.w), _leaf(tadj.w_t)
    xt = torch.from_numpy(x).requires_grad_(True)
    (t_spmm.propagate(tadj, xt, edge_grads=True) * torch.from_numpy(r)).sum().backward()
    _close(tadj.w.grad, jdw, "dw")
    _close(xt.grad, jdx, "dx")
    assert torch.all(tadj.w.grad[tadj.w == 0] == 0)  # padding slots
    assert torch.all(tadj.w_t.grad == 0)  # the transpose orientation: strict zeros


def test_bucketed_dw_matches_jax():
    src, tgt, w, n = _graph(hub_degree=30)
    x, r = _inputs(n, f=8, seed=3)
    jadj = j_spmm.build_bucketed_ell(src, tgt, w, n)
    assert len(jadj.idx) >= 2
    (jdw,), jdx = _jax_grads(jadj, ("w",), x, r)
    tadj = t_spmm.build_bucketed_ell(src, tgt, w, n, device="cpu")
    tadj.w = tuple(_leaf(b) for b in tadj.w)
    xt = torch.from_numpy(x).requires_grad_(True)
    (t_spmm.propagate(tadj, xt, edge_grads=True) * torch.from_numpy(r)).sum().backward()
    assert len(jdw) == len(tadj.w)
    for b, (got, ref) in enumerate(zip(tadj.w, jdw)):
        _close(got.grad, ref, f"bucket {b}")
    _close(xt.grad, jdx, "dx")


def test_coo_dw_matches_jax():
    src, tgt, w, n = _graph(seed=2)
    x, r = _inputs(n, f=8, seed=2)
    jadj = j_spmm.build_coo(src, tgt, w, n)
    (jdw,), jdx = _jax_grads(jadj, ("w",), x, r)
    tadj = t_spmm.build_coo(src, tgt, w, n, device="cpu")
    tadj.w, tadj.w_t = _leaf(tadj.w), _leaf(tadj.w_t)
    xt = torch.from_numpy(x).requires_grad_(True)
    (t_spmm.propagate(tadj, xt, edge_grads=True) * torch.from_numpy(r)).sum().backward()
    _close(tadj.w.grad, jdw, "dw")
    _close(xt.grad, jdx, "dx")
    assert torch.all(tadj.w_t.grad == 0)


def test_dense_is_differentiated_natively():
    rng = np.random.default_rng(4)
    at = rng.normal(size=(16, 16)).astype(np.float32)
    x, r = _inputs(16, f=6, seed=4)
    jdat = jax.grad(lambda a: jnp.sum(j_spmm.propagate(j_spmm.DenseAdj(at=a),
                                                       jnp.asarray(x)) * r))(jnp.asarray(at))
    ta = torch.from_numpy(at).requires_grad_(True)
    (t_spmm.propagate(t_spmm.DenseAdj(at=ta), torch.from_numpy(x), edge_grads=True)
     * torch.from_numpy(r)).sum().backward()
    _close(ta.grad, jdat)


@pytest.fixture(scope="module")
def trigram():
    seqs = [("P1", "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"), ("P2", "MKLVTAYIAKQRRQISFVK"),
            ("P3", "GLIEVQAPILSRVGDGTQDNLSGAEKAVQ")]
    g = NgramGraphBuilder(n_max=3).build_from_sequences(seqs)[2]
    src, tgt, val = j_transforms.csr_to_coo_arrays(g.mathcal_a_out())
    codes, alpha = j_hyper.vocab_char_codes(g.vocab)
    return g, src, tgt, val, codes, alpha


def _to_rs(w, layout, a, g):
    """A JAX K1 bank gradient in the port's r-major [A, G, A] layout."""
    w = np.asarray(w)
    if layout == "dual":  # g-major [G, A, A] (g, c, r)
        return w.transpose(2, 0, 1)
    if layout == "pk":  # packed [A*A, G] (r*A + c, g)
        return w.reshape(a, a, g).transpose(0, 2, 1)
    return w


@pytest.mark.parametrize("layout", ["dual", "rs", "pk"])
@pytest.mark.parametrize("scale,shift", [(1.0, 0.0), (0.5, 0.25)])
def test_hypercube_dd_dw_match_jax(trigram, layout, scale, shift):
    g, src, tgt, val, codes, alpha = trigram
    jadj = j_hyper.build_hypercube(src, tgt, val, codes, alpha, bank_layouts=layout)
    a, gk = np.asarray(jadj.d).shape
    x, r = _inputs(g.num_nodes, f=8, seed=5)
    xh = j_hyper.embed_features(jadj, jnp.asarray(x))
    rh = np.asarray(j_hyper.embed_features(jadj, jnp.asarray(r)))
    k1_leaf = "wf_gm" if layout == "dual" else "wf_rs"
    leaves = ("d", k1_leaf, "wb_rs")

    def loss(ws, xv):
        adj2 = jadj.replace(**dict(zip(leaves, ws)))
        return jnp.sum(j_hyper.propagate_hyper_affine(adj2, xv, scale, shift,
                                                      edge_grads=True) * rh)

    (jdd, jdwf, jdwb), jdx = jax.grad(loss, argnums=(0, 1))(
        tuple(getattr(jadj, k) for k in leaves), xh)
    tadj = t_hyper.build_hypercube(src, tgt, val, codes, alpha, device="cpu")
    tadj.d, tadj.wf_rs, tadj.wb_rs = _leaf(tadj.d), _leaf(tadj.wf_rs), _leaf(tadj.wb_rs)
    xt = torch.from_numpy(np.array(xh)).requires_grad_(True)
    out = t_hyper.propagate_hyper_affine(tadj, xt, scale, shift, edge_grads=True)
    (out * torch.from_numpy(rh)).sum().backward()
    _close(tadj.d.grad, jdd, "dd")
    _close(tadj.wf_rs.grad, _to_rs(jdwf, layout, a, gk), "dwf")
    _close(tadj.wb_rs.grad, _to_rs(jdwb, "pk" if layout == "pk" else "rs", a, gk), "dwb")
    _close(xt.grad, jdx, "dx")


def test_hypercube_through_propagate_and_propagate3(trigram):
    g, src, tgt, val, codes, alpha = trigram
    adj = t_hyper.build_hypercube(src, tgt, val, codes, alpha, device="cpu")
    adj.wf_rs = _leaf(adj.wf_rs)
    x = torch.from_numpy(_inputs(adj.n_out, f=4)[0])
    graph = DeviceGraph(adj, adj, adj, num_nodes=adj.n_out)
    sum(o.sum() for o in t_spmm.propagate3(graph, x, x, x, edge_grads=True)).backward()
    once = adj.wf_rs.grad.clone()
    adj.wf_rs.grad = None
    t_spmm.propagate(adj, x, edge_grads=True).sum().backward()
    torch.testing.assert_close(once, 3 * adj.wf_rs.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt", ["ell", "bucketed", "coo", "hypercube"])
def test_off_by_default(trigram, fmt):
    """Without ``edge_grads`` the graph's weights get no gradient."""
    g, src, tgt, val, codes, alpha = trigram
    n = g.num_nodes
    if fmt == "hypercube":
        adj = t_hyper.build_hypercube(src, tgt, val, codes, alpha, device="cpu")
        leaves = ("d", "wf_rs", "wb_rs")
        n = adj.n_out
    else:
        adj = getattr(t_spmm, f"build_{'bucketed_ell' if fmt == 'bucketed' else fmt}")(
            src, tgt, val, n, device="cpu")
        leaves = ("w",)
    for k in leaves:
        v = getattr(adj, k)
        setattr(adj, k, tuple(_leaf(b) for b in v) if isinstance(v, tuple) else _leaf(v))
    x = torch.from_numpy(_inputs(n, f=4)[0]).requires_grad_(True)
    t_spmm.propagate(adj, x).sum().backward()
    assert x.grad is not None
    for k in leaves:
        v = getattr(adj, k)
        assert all(b.grad is None for b in (v if isinstance(v, tuple) else (v,))), k


def test_edge_gradients_context_is_a_deprecated_shim():
    src, tgt, w, n = _graph()
    adj = t_spmm.build_ell(src, tgt, w, n, device="cpu")
    adj.w = _leaf(adj.w)
    x = torch.ones((n, 4), requires_grad=True)
    with pytest.warns(DeprecationWarning):
        with t_spmm.edge_gradients():
            assert t_spmm.edge_gradients_enabled()
            t_spmm.propagate(adj, x).sum().backward()
    assert not t_spmm.edge_gradients_enabled()
    assert torch.any(adj.w.grad[adj.w != 0] != 0)
    adj.w.grad = None
    with pytest.warns(DeprecationWarning):
        with t_spmm.edge_gradients():  # the explicit argument wins
            t_spmm.propagate(adj, x, edge_grads=False).sum().backward()
    assert adj.w.grad is None


@pytest.mark.parametrize("fmt", ["ell", "bucketed"])
def test_card_route_keeps_the_ell_kernels(monkeypatch, fmt):
    """With the card's route forced, an edge-gradient product and its dx run
    the ELL kernel wrappers (forward and backward), never ``ell_plain``;
    the SDDMM is the only plain torch beside them."""
    src, tgt, w, n = _graph(hub_degree=30 if fmt == "bucketed" else 0)
    x, r = _inputs(n)
    ref_adj = getattr(t_spmm, "build_ell" if fmt == "ell" else "build_bucketed_ell")(
        src, tgt, w, n, device="cpu")
    ref_adj.w = _leaf(ref_adj.w) if fmt == "ell" else tuple(_leaf(b) for b in ref_adj.w)
    xr = torch.from_numpy(x).requires_grad_(True)
    (t_spmm.propagate(ref_adj, xr, edge_grads=True) * torch.from_numpy(r)).sum().backward()

    plain = ell_kernels.ell_plain
    counts = {}

    def recorder(name, idx, wv, xv, direction):
        counts[(name, direction)] = counts.get((name, direction), 0) + 1
        return plain(idx, wv, xv)

    def refuse(*_):
        raise AssertionError("ell_plain ran on the card's route")

    monkeypatch.setattr(t_spmm, "_on_card", lambda t: True)
    monkeypatch.setattr(ell_kernels, "_launch", recorder)
    monkeypatch.setattr(ell_kernels, "ell_plain", refuse)
    adj = getattr(t_spmm, "build_ell" if fmt == "ell" else "build_bucketed_ell")(
        src, tgt, w, n, device="cpu")
    adj.w = _leaf(adj.w) if fmt == "ell" else tuple(_leaf(b) for b in adj.w)
    xt = torch.from_numpy(x).requires_grad_(True)
    (t_spmm.propagate(adj, xt, edge_grads=True) * torch.from_numpy(r)).sum().backward()
    buckets = 1 if fmt == "ell" else len(adj.w)
    assert counts == {("ell_resident", "fwd"): buckets, ("ell_resident", "bwd"): len(
        adj.w_t) if fmt == "bucketed" else 1}
    torch.testing.assert_close(xt.grad, xr.grad, rtol=0, atol=0)
    for got, ref in zip(adj.w if fmt == "bucketed" else (adj.w,),
                        ref_adj.w if fmt == "bucketed" else (ref_adj.w,)):
        torch.testing.assert_close(got.grad, ref.grad, rtol=0, atol=0)
