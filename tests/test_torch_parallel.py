"""Port parity: the node-sharded operators of ``parallel/`` (halo, tri-halo,
key-sharded hypercube and its tri operator) on 2 and 3 gloo ranks.

One spawn a world size runs every scenario (``tests/torch_dist_worker.py``,
torch and the port only); this process holds each rank's rows against the
JAX package's functions on a mesh of the same size (8 virtual CPU devices,
``tests/conftest.py``) and against the port's one-device ``propagate``:
forward and VJP in float32 at rtol 1e-5, atol 1e-6 x max|reference|; the
bfloat16 hypercube shard against the port's one-device bfloat16 product at
2 bf16 ulps of the largest value (the two split the same per-key sums, the
JAX package's keeps z in float32).  World size 3 gives an uneven key split
(G = 25 over 9 keys a rank) and two ring steps.  The exchange tables and
slabs equal the JAX package's array for array, and a corrupted exchange
trips ``debug_checksums`` on every rank.  ``PROTGRAM_HS_NOCOMM`` and
``PROTGRAM_HS_WIRE`` are read when a shard's operator is built, on one
shard in this process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protgram_directgcn_torch.config import ParallelConfig
from protgram_directgcn_torch.ops import hyper_kernels as t_hk, hypercube as t_hyper, spmm as t_spmm
from protgram_directgcn_torch.parallel import halo as t_halo, hyper_shard as t_hs, mesh as t_mesh
from protgram_directgcn_tpu.parallel import halo as j_halo, hyper_shard as j_hs
from protgram_directgcn_tpu.parallel.mesh import make_mesh as j_make_mesh
from tests import torch_dist_worker as W

RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(ref).max())), err_msg=what)


@pytest.fixture(scope="module", params=[2, 3], ids=["ws2", "ws3"])
def ranks(request, tmp_path_factory):
    ws = request.param
    d = tmp_path_factory.mktemp(f"parallel_ws{ws}")
    W.spawn(W.parallel_scenarios, ws, str(d))
    return ws, [dict(np.load(d / f"parallel_r{r}.npz")) for r in range(ws)]


def _fwd_vjp(fn, xs, cots):
    """``fn(*xs)`` and its VJP at ``cots``, as one jitted JAX program."""

    def both(xs_, cots_):
        out, vjp = jax.vjp(fn, *xs_)
        return out, vjp(cots_)

    return jax.jit(both)(tuple(jnp.asarray(x) for x in xs), cots)


def _assemble(results, key, rows_key, n_global):
    first = results[0][key]
    out = np.zeros((n_global,) + first.reshape(len(results[0][rows_key]), -1).shape[1:],
                   np.float64)
    for res in results:
        out[res[rows_key]] = res[key].reshape(len(res[rows_key]), -1)
    return out


def _halo_inputs(ws):
    coos = [W.random_coo(W.HALO_N, seed=s) for s in (0, 1, 2)]
    nd = -(-W.HALO_N // ws)
    pad = lambda a: np.pad(a, ((0, nd * ws - len(a)), (0, 0)))  # noqa: E731
    return coos, nd * ws, pad


def test_halo_matches_jax_and_one_device(ranks):
    ws, res = ranks
    coos, total, pad = _halo_inputs(ws)
    x = W.features(W.HALO_N, W.HALO_F, 3)
    cot = W.features(W.HALO_N, W.HALO_F, 9)
    jadj = j_halo.build_halo_adjacency(*coos[0], W.HALO_N, ws)
    with j_halo.active_mesh(j_make_mesh(ws, feat_axis=1)):
        jout, (jdx,) = _fwd_vjp(lambda v: j_halo.propagate_halo(jadj, v), [pad(x)],
                                jnp.asarray(pad(cot)))
    out = _assemble(res, "out_halo", "halo_rows", total)
    dx = _assemble(res, "dx_halo", "halo_rows", total)
    _close(out, jout, "out")
    _close(dx, jdx, "dx")
    ell = t_spmm.build_ell(*coos[0], W.HALO_N, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    (t_spmm.propagate(ell, xt) * torch.from_numpy(cot)).sum().backward()
    _close(out[: W.HALO_N], t_spmm.propagate(ell, torch.from_numpy(x)), "one-device out")
    _close(dx[: W.HALO_N], xt.grad, "one-device dx")


def test_tri_halo_matches_jax_and_one_device(ranks):
    ws, res = ranks
    coos, total, pad = _halo_inputs(ws)
    xs = [W.features(W.HALO_N, W.HALO_F, 3 + m) for m in range(3)]
    cot = jnp.asarray(pad(W.features(W.HALO_N, W.HALO_F, 9)))
    jtri = j_halo.build_tri_halo_adjacency(coos, W.HALO_N, ws)
    with j_halo.active_mesh(j_make_mesh(ws, feat_axis=1)):
        jouts, jdxs = _fwd_vjp(lambda a, b, c: j_halo.propagate_tri(jtri, a, b, c),
                               [pad(x) for x in xs], (cot, cot, cot))
    for m in range(3):
        out = _assemble(res, f"out_trihalo{m}", "halo_rows", total)
        _close(out, jouts[m], f"out {m}")
        _close(_assemble(res, f"dx_trihalo{m}", "halo_rows", total), jdxs[m], f"dx {m}")
        ell = t_spmm.build_ell(*coos[m], W.HALO_N, device="cpu")
        _close(out[: W.HALO_N], t_spmm.propagate(ell, torch.from_numpy(xs[m])), f"one-device {m}")


def _hyper_setup(ws):
    src, tgt, w, codes, a, num = W.ngram_coo()
    jadj = [j_hs.build_hyper_shard(*W.ngram_coo(seed=s)[:3], codes, a, ws) for s in (0, 1, 2)]
    gp = jadj[0].g_padded
    node_map = np.asarray(jadj[0].node_map)

    def pad(arr):
        full = np.zeros((a * gp, arr.shape[1]), np.float32)
        full[node_map] = arr
        return full

    return codes, a, num, jadj, gp, pad


def test_hyper_shard_matches_jax_and_one_device(ranks):
    ws, res = ranks
    codes, a, num, jadj, gp, pad = _hyper_setup(ws)
    x = W.features(num, W.HYPER_F, 4)
    cot = W.features(num, W.HYPER_F, 9)
    with j_halo.active_mesh(j_make_mesh(ws, feat_axis=1)):
        jout, (jdx,) = _fwd_vjp(
            lambda v: j_hs.propagate_hyper_shard(jadj[0], v, W.SCALE, W.SHIFT), [pad(x)],
            jnp.asarray(pad(cot)))
    out = _assemble(res, "out_hyper_f32", "hyper_rows", a * gp)
    dx = _assemble(res, "dx_hyper_f32", "hyper_rows", a * gp)
    _close(out, jout, "out")
    _close(dx, jdx, "dx")
    one = t_hyper.build_hypercube(*W.ngram_coo()[:3], codes, a, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)  # the hypercube is full: real == hyper ids
    ref = t_hyper.propagate_hyper_affine(one, xt, W.SCALE, W.SHIFT)
    (ref * torch.from_numpy(cot)).sum().backward()
    node_map = np.asarray(jadj[0].node_map)
    _close(out[node_map], ref.detach(), "one-device out")
    _close(dx[node_map], xt.grad, "one-device dx")


def test_hyper_shard_bf16_matches_one_device(ranks):
    ws, res = ranks
    codes, a, num, jadj, gp, pad = _hyper_setup(ws)
    one = t_hyper.build_hypercube(*W.ngram_coo()[:3], codes, a, device="cpu",
                                  weights_dtype=torch.bfloat16)
    xt = torch.from_numpy(W.features(num, W.HYPER_F, 4)).to(torch.bfloat16).requires_grad_(True)
    ref = t_hyper.propagate_hyper_affine(one, xt, W.SCALE, W.SHIFT)
    (ref.float() * torch.from_numpy(W.features(num, W.HYPER_F, 9))).sum().backward()
    node_map = np.asarray(jadj[0].node_map)
    for key, want in (("out", ref.detach().float()), ("dx", xt.grad.float())):
        got = _assemble(res, f"{key}_hyper_bf16", "hyper_rows", a * gp)[node_map]
        tol = 2 * 2.0**-8 * float(want.abs().max())
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=tol, err_msg=key)


def test_hyper_shard_tri_matches_jax(ranks):
    ws, res = ranks
    codes, a, num, jadj, gp, pad = _hyper_setup(ws)
    xs = [jnp.asarray(pad(W.features(num, W.HYPER_F, 4 + m)).reshape(a, gp, -1))
          for m in range(3)]
    cot = jnp.asarray(pad(W.features(num, W.HYPER_F, 9)).reshape(a, gp, -1))
    tri = j_hs.HyperShardTri(adjs=tuple(jadj))
    with j_halo.active_mesh(j_make_mesh(ws, feat_axis=1)):
        jouts, jdxs = _fwd_vjp(lambda p, q, r: j_hs.propagate_hyper_shard_tri(tri, p, q, r),
                               xs, (cot, cot, cot))
    for m in range(3):
        _close(_assemble(res, f"out_hypertri{m}", "hyper_rows", a * gp),
               np.asarray(jouts[m]).reshape(a * gp, -1), f"out {m}")
        _close(_assemble(res, f"dx_hypertri{m}", "hyper_rows", a * gp),
               np.asarray(jdxs[m]).reshape(a * gp, -1), f"dx {m}")


def test_debug_checksums_trip_on_a_corrupted_exchange(ranks):
    ws, res = ranks
    assert all(bool(r["checksum_tripped"]) for r in res)
    # Exchanges happened, with healthy checksums before the corrupted one.
    assert all(int(r["exchange_calls"]) > 0 for r in res)


@pytest.mark.parametrize("ws", [2, 3, 4])
def test_halo_tables_equal_jax(ws):
    coos, _, _ = _halo_inputs(ws)
    t = t_halo.build_halo_tables(*coos[0], W.HALO_N, ws)
    j = j_halo.build_halo_partition(*coos[0], W.HALO_N, ws)
    for k in ("local_idx", "local_w", "halo_idx", "halo_w"):
        np.testing.assert_array_equal(t[k], np.asarray(getattr(j, k)), err_msg=k)
    assert len(t["send_steps"]) == len(j.send_steps) == ws - 1
    for a_, b_ in zip(t["send_steps"], j.send_steps):
        np.testing.assert_array_equal(a_, np.asarray(b_))
    assert t["rows_per_shard"] == j.rows_per_shard
    jt = j_halo.build_tri_halo_partition(coos, W.HALO_N, ws)
    for tt, jp in zip(t_halo.build_tri_halo_tables(coos, W.HALO_N, ws), jt.parts):
        for k in ("local_idx", "local_w", "halo_idx", "halo_w"):
            np.testing.assert_array_equal(tt[k], np.asarray(getattr(jp, k)), err_msg=k)
        for a_, b_ in zip(tt["send_steps"], jt.send_steps):
            np.testing.assert_array_equal(a_, np.asarray(b_))


@pytest.mark.parametrize("ws", [2, 3, 4])
def test_hyper_shard_tables_and_slabs_equal_jax(ws):
    src, tgt, w, codes, a, num = W.ngram_coo()
    t = t_hs.build_hyper_shard_tables(a, a ** 2, ws)
    j = j_hs.build_hyper_shard_tables(a, a ** 2, ws)
    for k in ("send_gc", "asm_gc", "send_rg", "asm_rg"):
        np.testing.assert_array_equal(t[k], np.asarray(getattr(j, k)), err_msg=k)
    ts = t_hs.build_hyper_shard_slabs(src, tgt, w, codes, a, ws)
    js = j_hs.build_hyper_shard(src, tgt, w, codes, a, ws)
    for k in ("d", "wf", "wb", "node_map"):
        np.testing.assert_array_equal(ts[k], np.asarray(getattr(js, k)), err_msg=k)


def test_layout_and_config_refusals():
    """The gspmd mode and feature shards are accepted (the runs themselves:
    tests/test_torch_trainer_distributed.py, tests/test_torch_gspmd.py); a
    grid the world size does not fill, an unknown mode, a shard count below
    1 and a width the feature shards do not divide are refused."""
    with pytest.raises(ValueError, match="world size 1"):
        t_mesh.make_mesh(2)
    with pytest.raises(ValueError, match="world size 1"):
        t_mesh.make_mesh(1, feat_axis=2)
    for good in (ParallelConfig(mode="gspmd"), ParallelConfig(mesh_feats=2),
                 ParallelConfig(mesh_nodes=2, mesh_feats=2, mode="hypercube")):
        good.check()
    with pytest.raises(ValueError, match="unknown parallel.mode"):
        ParallelConfig(mode="ring").check()
    with pytest.raises(ValueError, match="at least 1"):
        ParallelConfig(mesh_feats=0).check()
    assert t_mesh.make_mesh(1) == t_mesh.RankLayout(node_shards=1, rank=0)
    assert t_mesh.make_mesh(1).feat is None
    # JAX's device_put refuses PartitionSpec(None, "feat") on dims [15, 8]
    # over 2 feature shards; the port names the leaf and its width.
    tree = {"layers": [{"w_main_in": torch.ones(12, 15), "b_main_in": torch.zeros(15)}],
            "res_projs": [None], "decoder": {"w1": torch.ones(8, 4)}}
    with pytest.raises(ValueError, match=r"width 15 of layers\[0\].b_main_in"):
        t_mesh.shard_model_params(tree, torch.arange(3), 3, t_mesh.FeatShard(2, 0))


def test_shard_model_params_keeps_the_rows_of_node_leaves():
    n = 12
    tree = {"layers": [{"c_in": torch.arange(n, dtype=torch.float32)[:, None],
                        "constant": torch.arange(2 * n, dtype=torch.float32).view(n, 2),
                        "w_main_in": torch.ones(3, 2), "b_main_in": torch.zeros(2)}],
            "res_projs": [None], "decoder": {"w1": torch.ones(2, 1)}}
    rows = torch.tensor([1, 5, 7])
    out = t_mesh.shard_model_params(tree, rows, n)
    assert out["layers"][0]["c_in"].view(-1).tolist() == [1.0, 5.0, 7.0]
    torch.testing.assert_close(out["layers"][0]["constant"], tree["layers"][0]["constant"][rows])
    assert out["layers"][0]["w_main_in"] is tree["layers"][0]["w_main_in"]
    assert out["decoder"]["w1"] is tree["decoder"]["w1"]
    # Over 2 feature shards, rank 1 keeps the second half of each split axis.
    wide = dict(tree, decoder={"w1": torch.arange(4.0).view(2, 2), "w2": torch.ones(2, 3),
                               "b2": torch.zeros(3)})
    cut = t_mesh.shard_model_params(wide, rows, n, t_mesh.FeatShard(2, 1))
    assert cut["layers"][0]["w_main_in"].shape == (3, 1)
    assert cut["layers"][0]["b_main_in"].shape == (1,)
    torch.testing.assert_close(cut["layers"][0]["constant"], out["layers"][0]["constant"])
    assert cut["decoder"]["w1"].view(-1).tolist() == [1.0, 3.0]
    assert cut["decoder"]["w2"].shape == (1, 3) and cut["decoder"]["b2"].shape == (3,)


def _one_shard(monkeypatch, env):
    """The n-gram matrix as one key shard (D = 1, outside a process group),
    built under ``env``, which is unset again before it propagates."""
    src, tgt, w, codes, a, num = W.ngram_coo()
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    adj = t_hs.build_hyper_shard(src, tgt, w, codes, a, 1, 0, "cpu")
    for key in env:
        monkeypatch.delenv(key)
    one = t_hyper.build_hypercube(src, tgt, w, codes, a, device="cpu")
    x = torch.from_numpy(W.features(num, W.HYPER_F, 4))
    return adj, one, x


def test_hs_nocomm_is_read_at_build_and_skips_every_exchange(monkeypatch):
    adj, one, x = _one_shard(monkeypatch, {"PROTGRAM_HS_NOCOMM": "1"})
    assert adj.nocomm and not adj.wire_bf16

    def no_exchange(*_a, **_k):
        raise AssertionError("an exchange ran under PROTGRAM_HS_NOCOMM=1")

    monkeypatch.setattr(t_hs.comm, "all_to_all", no_exchange)
    got = t_hs.propagate(adj, x, W.SCALE, W.SHIFT)
    # One shard's exchanges are relayouts only, so the identity is exact here.
    ref = t_hyper.propagate_hyper_affine(one, x, W.SCALE, W.SHIFT)
    _close(got, ref, "one shard without exchanges")
    adj.nocomm = False
    with pytest.raises(AssertionError, match="an exchange ran"):
        t_hs.propagate(adj, x)


def test_hs_wire_bf16_is_read_at_build_and_rounds_what_crosses(monkeypatch):
    adj, one, x = _one_shard(monkeypatch, {"PROTGRAM_HS_WIRE": "bf16"})
    assert adj.wire_bf16 and not adj.nocomm
    got = t_hs.propagate(adj, x, W.SCALE, W.SHIFT)
    a, g = adj.feature_shape
    x_rg = x.view(a, g, -1)
    rnd = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    # The gc operand and z cross the wire; the diagonal term reads x itself.
    z = t_hk.k1_plain(adj.wf, x_rg)
    want = t_hk.k2_plain(adj.d, adj.wb, rnd(z).view(a, g, -1), x_rg, W.SCALE, W.SHIFT,
                         x_gc=rnd(x).view(g, a, -1))
    _close(got, want.view(a * g, -1), "bf16 wire")
    exact = t_hyper.propagate_hyper_affine(one, x, W.SCALE, W.SHIFT)
    assert not torch.equal(got, exact)
    adj.wire_bf16 = False
    _close(t_hs.propagate(adj, x, W.SCALE, W.SHIFT), exact, "f32 wire")
