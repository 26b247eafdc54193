"""Port parity: the gspmd mode's row-sharded ELL operator
(``parallel/gspmd.py``) on 2 and 3 gloo ranks.

Each rank keeps its block of the ELL tables' rows, gathers the node-sharded
features over the node group and runs its rows; the backward gathers the
cotangent and runs its rows of the transpose table.  One spawn a world size
(``tests/torch_dist_worker.py``); this process holds each rank's rows of the
product and of its VJP against the JAX package's ``shard_device_graph`` +
``propagate`` on a mesh of the same size (8 virtual CPU devices,
``tests/conftest.py``) and against the port's one-device ``EllAdj``, at rtol
1e-6 (atol 1e-7 x max|reference|: the same products summed in the same
slot order).  The row-padded tables equal the JAX package's array for
array.  On the card's route (``spmm._on_card`` made true, recording
wrappers) both directions reach the ELL kernels, never their plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from protgram_directgcn_torch.ops import ell_kernels as ek, spmm as t_spmm
from protgram_directgcn_torch.parallel import gspmd as t_gspmd
from protgram_directgcn_tpu.graph.structure import DeviceGraph as JDeviceGraph
from protgram_directgcn_tpu.ops import spmm as j_spmm
from protgram_directgcn_tpu.parallel.mesh import make_mesh as j_make_mesh, shard_device_graph
from tests import torch_dist_worker as W
from tests.test_torch_ell import _recorders

RTOL, ATOL = 1e-6, 1e-7


def _close(got, ref, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(ref).max())), err_msg=what)


@pytest.fixture(scope="module", params=[2, 3], ids=["ws2", "ws3"])
def ranks(request, tmp_path_factory):
    ws = request.param
    d = tmp_path_factory.mktemp(f"gspmd_ws{ws}")
    W.spawn(W.gspmd_scenarios, ws, str(d))
    return ws, [dict(np.load(d / f"gspmd_r{r}.npz")) for r in range(ws)]


def _assemble(results, key, total):
    out = np.zeros((total, W.HALO_F))
    for res in results:
        out[res["rows"]] = res[key]
    return out


def _jax_rows(coo, ws, xs, cot):
    """JAX ``shard_device_graph`` of the matrix's ELL operator on a ws-shard
    mesh: each padded input's product and VJP at ``cot``."""
    ell = j_spmm.build_ell(*coo, W.HALO_N)
    mesh = j_make_mesh(ws, feat_axis=1)
    dg = shard_device_graph(JDeviceGraph(p_in=ell, p_out=ell, p_und=ell, num_nodes=W.HALO_N),
                            mesh)
    sharding = NamedSharding(mesh, P("nodes", None))
    outs, dxs = [], []
    for x in xs:
        out, vjp = jax.vjp(lambda v: j_spmm.propagate(dg.p_in, v),
                           jax.device_put(jnp.asarray(x), sharding))
        outs.append(np.asarray(out))
        dxs.append(np.asarray(vjp(jax.device_put(jnp.asarray(cot), sharding))[0]))
    return dg.p_in, outs, dxs


@pytest.mark.parametrize("ws", [2, 3])
def test_row_shard_tables_equal_jax(ws):
    coo = W.random_coo(W.HALO_N, seed=0)
    t = t_gspmd.build_row_shard_tables(*coo, W.HALO_N, ws)
    jp = _jax_rows(coo, ws, [], None)[0]
    for k in ("idx", "w", "idx_t", "w_t"):
        np.testing.assert_array_equal(t[k], np.asarray(getattr(jp, k)), err_msg=k)
    assert t["rows_per_shard"] * ws == np.asarray(jp.idx).shape[0]


def test_row_shard_matches_jax_and_one_device(ranks):
    ws, res = ranks
    total = -(-W.HALO_N // ws) * ws
    pad = lambda a: np.pad(a, ((0, total - len(a)), (0, 0)))  # noqa: E731
    x, cot = W.features(W.HALO_N, W.HALO_F, 3), W.features(W.HALO_N, W.HALO_F, 9)
    for tag, m, xm in [("gspmd", 0, x)] + [(f"gspmdtri{m}", m, W.features(W.HALO_N, W.HALO_F,
                                                                          3 + m))
                                           for m in range(3)]:
        coo = W.random_coo(W.HALO_N, seed=m)
        _, (jout,), (jdx,) = _jax_rows(coo, ws, [pad(xm)], pad(cot))
        out, dx = _assemble(res, f"out_{tag}", total), _assemble(res, f"dx_{tag}", total)
        _close(out, jout, f"{tag} out")
        _close(dx, jdx, f"{tag} dx")
        ell = t_spmm.build_ell(*coo, W.HALO_N, device="cpu")
        xt = torch.from_numpy(xm).requires_grad_(True)
        y = t_spmm.propagate(ell, xt)
        (y * torch.from_numpy(cot)).sum().backward()
        _close(out[: W.HALO_N], y.detach(), f"{tag} one-device out")
        _close(dx[: W.HALO_N], xt.grad, f"{tag} one-device dx")
        assert not out[W.HALO_N:].any()
    # One gather a direction: the single operator's 2, the tri operator's 2.
    assert all(int(r["exchange_calls"]) == 4 for r in res)


@pytest.mark.parametrize("n,expect", [(50, "ell_resident"), (16_385, "ell_hbm")])
def test_card_route_reaches_the_kernels(monkeypatch, n, expect):
    """One shard, outside a process group: the gathered table's rows pick
    the kernel (the one-device regime), both directions, never the plain
    version; the values are the plain route's."""
    coo = W.random_coo(n, edges=4 * n, seed=1)
    adj = t_gspmd.RowShardEllAdj.from_tables(t_gspmd.build_row_shard_tables(*coo, n, 1), 1, 0,
                                             "cpu")
    x = torch.from_numpy(W.features(n, 5, 3))
    cot = torch.from_numpy(W.features(n, 5, 9))
    x_ref = x.clone().requires_grad_(True)
    (t_gspmd.propagate(adj, x_ref) * cot).sum().backward()
    calls = []
    _recorders(monkeypatch, calls)
    monkeypatch.setattr(t_spmm, "_on_card", lambda t: True)
    xt = x.clone().requires_grad_(True)
    y = t_spmm.propagate(adj, xt)
    (y * cot).sum().backward()
    assert calls == [(expect, "fwd", tuple(adj.idx.shape)), (expect, "bwd", tuple(adj.idx_t.shape))]
    np.testing.assert_array_equal(xt.grad.numpy(), x_ref.grad.numpy())
    calls.clear()
    tri = t_gspmd.RowShardTri(adjs=(adj, adj, adj))
    outs = t_spmm.propagate3(type("G", (), {"tri": tri})(), xt, xt, xt)
    sum(o.sum() for o in outs).backward()
    assert [c[:2] for c in calls] == [(expect, "fwd")] * 3 + [(expect, "bwd")] * 3
