"""Port parity: hypercube banks, the K1/K2 plain versions and their autograd.

The port's ``ops.hypercube`` / ``ops.hyper_kernels`` on the CPU (where the
wrappers run the kernels' plain PyTorch versions) against the JAX package:

- banks: byte-exact against JAX's r-major banks;
- f32 propagation: against ``_hyper_apply``'s einsum path, rtol 1e-5 /
  atol 1e-6 (f32 sums of <= 2A+1 terms in another order);
- bf16: against the Pallas kernels in interpret mode at G >= 128, max abs
  error <= 0.05 * max|ref| (the bound tests/test_hypercube.py pins for bf16);
- backward: against ``jax.vjp`` of ``propagate_hyper_affine``, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder as TBuilder
from protgram_directgcn_torch.graph import transforms as t_transforms
from protgram_directgcn_torch.ops import hyper_kernels as hk
from protgram_directgcn_torch.ops import hypercube as t_hyper
from protgram_directgcn_tpu.graph.builder import NgramGraphBuilder as JBuilder
from protgram_directgcn_tpu.ops import hypercube as j_hyper

SEQS = [
    ("P1", "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"),
    ("P2", "MKLVTAYIAKQRRQISFVK"),
    ("P3", "GLIEVQAPILSRVGDGTQDNLSGAEKAVQ"),
]
MATRICES = ["mathcal_a_in", "mathcal_a_out", "undirected_norm"]


@pytest.fixture(scope="module")
def graphs():
    return JBuilder(n_max=3).build_from_sequences(SEQS), TBuilder(n_max=3).build_from_sequences(SEQS)


def _coo(graph, matrix):
    return t_transforms.csr_to_coo_arrays(getattr(graph, matrix)())


def _jax_adj(graph, matrix, layout="rs", dtype=jnp.float32):
    codes, alpha = j_hyper.vocab_char_codes(graph.vocab)
    return j_hyper.build_hypercube(*_coo(graph, matrix), codes, alpha,
                                   weights_dtype=dtype, bank_layouts=layout)


def _port_adj(graph, matrix, dtype=torch.float32):
    codes, alpha = t_hyper.vocab_char_codes(graph.vocab)
    return t_hyper.build_hypercube(*_coo(graph, matrix), codes, alpha,
                                   weights_dtype=dtype, device="cpu")


def _x(adj_shape, f, seed):
    a, g = adj_shape
    return np.random.default_rng(seed).normal(size=(a, g, f)).astype(np.float32)


@pytest.mark.parametrize("level", [2, 3])
@pytest.mark.parametrize("matrix", MATRICES)
def test_banks_byte_exact(graphs, level, matrix):
    jg, tg = graphs
    j = _jax_adj(jg[level - 1], matrix)
    t = _port_adj(tg[level - 1], matrix)
    for jv, tv in ((j.d, t.d), (j.wf_rs, t.wf_rs), (j.wb_rs, t.wb_rs)):
        jv = np.asarray(jv)
        assert tv.numpy().dtype == jv.dtype and tv.numpy().tobytes() == jv.tobytes()
    np.testing.assert_array_equal(t.node_map.numpy(), np.asarray(j.node_map))


@pytest.mark.parametrize("layout", ["dual", "rs", "pk"])
@pytest.mark.parametrize("matrix", MATRICES)
def test_hyper_from_jax_any_layout(graphs, layout, matrix):
    jg, tg = graphs
    j = _jax_adj(jg[2], matrix, layout)
    t = convert.hyper_from_jax(j, device="cpu")
    ref = _port_adj(tg[2], matrix)
    assert t.wf_rs.shape == ref.wf_rs.shape
    assert torch.equal(t.wf_rs, ref.wf_rs) and torch.equal(t.wb_rs, ref.wb_rs)
    x = _x(t.feature_shape, 12, seed=1)
    want = np.asarray(j_hyper.propagate_hyper(j, jnp.asarray(x)))
    got = t_hyper.propagate_hyper(t, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("f", [8, 40, 128])
@pytest.mark.parametrize("scale,shift", [(1.0, 0.0), (0.5, 0.25)])
@pytest.mark.parametrize("swap", [False, True])
def test_plain_matches_einsum_path_f32(graphs, f, scale, shift, swap):
    jg, tg = graphs
    j = _jax_adj(jg[2], "mathcal_a_out")
    t = _port_adj(tg[2], "mathcal_a_out")
    x = _x(t.feature_shape, f, seed=f)
    jw1, jw2 = (j.wb_rs, j.wf_rs) if swap else (j.wf_rs, j.wb_rs)
    tw1, tw2 = (t.wb_rs, t.wf_rs) if swap else (t.wf_rs, t.wb_rs)
    want = np.asarray(j_hyper._hyper_apply(j.d, jw1, jw2, jnp.asarray(x), scale, shift,
                                           w_layout="rs"))
    got = t_hyper._hyper_apply(t.d, tw1, tw2, torch.from_numpy(x), scale, shift).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_k1_then_view_is_the_a_pattern(graphs):
    """K1 writes [G, A, F]; its rg view holds node g*A + c at flat row g*A + c."""
    _, tg = graphs
    t = _port_adj(tg[2], "mathcal_a_out")
    a, g = t.feature_shape
    x = torch.from_numpy(_x((a, g), 4, seed=2))
    z = hk.k1(t.wf_rs, x)
    assert z.shape == (g, a, 4)
    want = torch.einsum("rgc,rgf->gcf", t.wf_rs, x).reshape(a * g, 4)
    torch.testing.assert_close(z.view(a, g, 4).reshape(a * g, 4), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("swap", [False, True])
def test_plain_matches_pallas_interpret_bf16(graphs, swap):
    from protgram_directgcn_tpu.ops.pallas_hyper import apply_hyper_pallas

    jg, tg = graphs
    j = _jax_adj(jg[2], "mathcal_a_in", dtype=jnp.bfloat16)
    t = _port_adj(tg[2], "mathcal_a_in", dtype=torch.bfloat16)
    a, g = t.feature_shape
    assert g >= 128
    x = _x((a, g), 128, seed=5)
    jw1, jw2 = (j.wb_rs, j.wf_rs) if swap else (j.wf_rs, j.wb_rs)
    tw1, tw2 = (t.wb_rs, t.wf_rs) if swap else (t.wf_rs, t.wb_rs)
    ref = np.asarray(apply_hyper_pallas(j.d, jw1, jw2, jnp.asarray(x, jnp.bfloat16),
                                        interpret=True, w_layout="rs"), np.float32)
    got = t_hyper._hyper_apply(t.d, tw1, tw2, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= 0.05 * np.abs(ref).max()


@pytest.mark.parametrize("scale,shift", [(1.0, 0.0), (0.7, -0.3)])
@pytest.mark.parametrize("flat", [False, True])
def test_autograd_backward_matches_jax_vjp(graphs, scale, shift, flat):
    jg, tg = graphs
    j = _jax_adj(jg[2], "mathcal_a_out")
    t = _port_adj(tg[2], "mathcal_a_out")
    a, g = t.feature_shape
    x = _x((a, g), 16, seed=11)
    cot = _x((a, g), 16, seed=12)
    if flat:
        x, cot = x.reshape(a * g, 16), cot.reshape(a * g, 16)
    out_j, vjp = jax.vjp(lambda v: j_hyper.propagate_hyper_affine(j, v, scale, shift),
                         jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    hk.reset_launches()
    out_t = t_hyper.propagate_hyper_affine(t, xt, scale, shift)
    out_t.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-5, atol=1e-6)
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert hk.launch_counts() == {"k1": {"fwd": 0, "bwd": 0}, "k2": {"fwd": 0, "bwd": 0}}


def test_transpose_matches_dense(graphs):
    _, tg = graphs
    graph = tg[2]
    src, tgt, val = _coo(graph, "mathcal_a_out")
    t = _port_adj(graph, "mathcal_a_out")
    n = graph.num_nodes
    at = np.zeros((n, n))
    np.add.at(at, (tgt, src), val)
    x = np.random.default_rng(4).normal(size=(n, 6)).astype(np.float32)
    xh = t_hyper.embed_features(t, torch.from_numpy(x))
    fwd = t_hyper.extract_features(t, t_hyper.propagate_hyper(t, xh)).numpy()
    bwd = t_hyper.extract_features(t, t_hyper.propagate_hyper_transpose(t, xh)).numpy()
    np.testing.assert_allclose(fwd, at @ x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bwd, at.T @ x, rtol=1e-5, atol=1e-5)


def test_wrappers_check_their_inputs():
    a, g, f = 3, 4, 5
    x = torch.zeros(a, g, f)
    w = torch.zeros(a, g, a)
    d = torch.zeros(a, g)
    with pytest.raises(ValueError):
        hk.k1(torch.zeros(a, g, a + 1), x)
    with pytest.raises(TypeError):
        hk.k1(w.double(), x)
    with pytest.raises(TypeError):
        hk.k1(w.half(), x.half())
    with pytest.raises(ValueError):
        hk.k1(w, x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(TypeError):
        hk.k2(d.double(), w, x, x)
    with pytest.raises(ValueError):
        hk.k2(d, w, torch.zeros(a, g, f + 1), x)
    with pytest.raises(ValueError):
        hk.k1(w.to("meta"), x.to("meta"))


def test_build_hypercube_rejects_over_budget_and_1grams(graphs):
    _, tg = graphs
    g3 = tg[2]
    codes, alpha = t_hyper.vocab_char_codes(g3.vocab)
    with pytest.raises(t_hyper.BankBudgetError):
        t_hyper.build_hypercube(*_coo(g3, "mathcal_a_out"), codes, alpha, max_block_bytes=1024,
                                device="cpu")
    codes1, alpha1 = t_hyper.vocab_char_codes(tg[0].vocab)
    with pytest.raises(t_hyper.BlockStructureError):
        t_hyper.build_hypercube(*_coo(tg[0], "mathcal_a_out"), codes1, alpha1, device="cpu")
