"""GNN zoo: the seven baseline architectures of the benchmark.

Port of protgram_directgcn_tpu/models/zoo.py (reference:
src/models/gnn_zoo.py): GCN, GAT, GraphSAGE, GIN, ChebNet, RGCN and
TongDiGCN.  Each model binds a static graph at construction: its
propagation operators are built on the host by the JAX package's numpy code
and put on the device through ``spmm.build_adjacency`` (dense, ELL or
bucketed ELL by the same rule), so ELL operators run the ELL kernels on the
card.  Parameters are nested dicts of tensors with the JAX package's names
and layouts (``x @ w``), so ``convert.zoo_params_from_jax`` maps one onto
the other.  ``init_params(gen)`` draws them from a ``torch.Generator``
(Glorot with the JAX fan rule, zero biases); ``apply(params, x, train,
gen)`` returns ``(logits, embeddings)``, with dropout masks drawn from
``gen`` when training.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from protgram_directgcn_torch.ops.segment import segment_softmax
from protgram_directgcn_torch.ops.spmm import build_adjacency, propagate
from protgram_directgcn_torch.utils.device import resolve_device

Params = Dict
Device = Union[str, torch.device]


# ----------------------------------------------------------------------------
# Host-side normalized operator builders (byte-equal to zoo.py:31-76 of the
# JAX package)
# ----------------------------------------------------------------------------


def _gcn_norm_adj(edge_index: np.ndarray, edge_weight: Optional[np.ndarray], n: int,
                  feat_dim: int, device: Device):
    """Â = D̂^-1/2 (A + I) D̂^-1/2 (PyG GCNConv normalization, fill=1)."""
    src, tgt = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    w = np.ones(len(src), np.float32) if edge_weight is None else edge_weight.astype(np.float32)
    loops = np.arange(n, dtype=np.int64)
    src = np.concatenate([src, loops])
    tgt = np.concatenate([tgt, loops])
    w = np.concatenate([w, np.ones(n, np.float32)])
    deg = np.zeros(n, np.float32)
    np.add.at(deg, tgt, w)
    with np.errstate(divide="ignore"):
        dinv = deg ** -0.5
    dinv[~np.isfinite(dinv)] = 0.0
    vals = dinv[src] * w * dinv[tgt]
    return build_adjacency(src.astype(np.int32), tgt.astype(np.int32), vals, n,
                           feat_dim=feat_dim, device=device)


def _mean_adj(edge_index: np.ndarray, n: int, feat_dim: int, device: Device):
    """Mean aggregation over incoming edges (SAGE/RGCN)."""
    src, tgt = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    deg = np.bincount(tgt, minlength=n).astype(np.float32)
    inv = np.divide(1.0, deg, out=np.zeros_like(deg), where=deg > 0)
    return build_adjacency(src.astype(np.int32), tgt.astype(np.int32), inv[tgt], n,
                           feat_dim=feat_dim, device=device)


def _sum_adj(edge_index: np.ndarray, edge_weight: Optional[np.ndarray], n: int, feat_dim: int,
             device: Device):
    src, tgt = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    w = np.ones(len(src), np.float32) if edge_weight is None else edge_weight.astype(np.float32)
    return build_adjacency(src.astype(np.int32), tgt.astype(np.int32), w, n,
                           feat_dim=feat_dim, device=device)


def _cheb_operator(edge_index: np.ndarray, edge_weight: Optional[np.ndarray], n: int,
                   feat_dim: int, device: Device):
    """L̂ = -D^-1/2 A D^-1/2 (sym norm, λmax=2, PyG ChebConv default)."""
    src, tgt = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    w = np.ones(len(src), np.float32) if edge_weight is None else edge_weight.astype(np.float32)
    deg = np.zeros(n, np.float32)
    np.add.at(deg, tgt, w)
    with np.errstate(divide="ignore"):
        dinv = deg ** -0.5
    dinv[~np.isfinite(dinv)] = 0.0
    vals = -dinv[src] * w * dinv[tgt]
    return build_adjacency(src.astype(np.int32), tgt.astype(np.int32), vals, n,
                           feat_dim=feat_dim, device=device)


# ----------------------------------------------------------------------------
# Shared init helpers
# ----------------------------------------------------------------------------


def _glorot(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Glorot uniform with the JAX package's fans, ``shape[-2]`` and
    ``shape[-1]`` (GAT's ``[1, H, D]`` attention vectors: fan_in = H)."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (u * (2 * limit) - limit).to(device)


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator], train: bool):
    if not train or gen is None or rate <= 0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class BaseZooModel:
    """Binds a static graph; subclasses define init_params/apply."""

    name = "base"

    def __init__(self, edge_index: np.ndarray, num_nodes: int,
                 edge_weight: Optional[np.ndarray] = None, feat_dim: int = 64,
                 device: Device = "cuda"):
        self.edge_index = edge_index
        self.edge_weight = edge_weight
        self.num_nodes = num_nodes
        self.feat_dim = feat_dim
        self.device = resolve_device(device)

    def init_params(self, gen: torch.Generator) -> Params:
        raise NotImplementedError

    def apply(self, params: Params, x: torch.Tensor, train: bool = False,
              gen: Optional[torch.Generator] = None):
        """Returns (logits, embeddings), the embeddings by the reference's
        get_embeddings semantics for this architecture."""
        raise NotImplementedError

    def _zeros(self, n: int) -> torch.Tensor:
        return torch.zeros(n, device=self.device)


def _stack_dims(in_dim: int, hidden_dim: int, out_dim: int, num_layers: int):
    return [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]


# ----------------------------------------------------------------------------
# GCN (reference: gnn_zoo.py:35-56)
# ----------------------------------------------------------------------------


class GCN(BaseZooModel):
    name = "GCN"

    def __init__(self, edge_index, num_nodes, in_dim, hidden_dim, out_dim,
                 num_layers=2, dropout_rate=0.5, edge_weight=None, device="cuda"):
        super().__init__(edge_index, num_nodes, edge_weight, hidden_dim, device)
        self.dims = _stack_dims(in_dim, hidden_dim, out_dim, num_layers)
        self.dropout_rate = dropout_rate
        self.adj = _gcn_norm_adj(edge_index, edge_weight, num_nodes, hidden_dim, self.device)

    def init_params(self, gen):
        return {"layers": [{"w": _glorot(gen, (self.dims[i], self.dims[i + 1]), self.device),
                            "b": self._zeros(self.dims[i + 1])}
                           for i in range(len(self.dims) - 1)]}

    def apply(self, params, x, train=False, gen=None):
        h = x
        n_layers = len(params["layers"])
        for i, lp in enumerate(params["layers"]):
            h = propagate(self.adj, h @ lp["w"]) + lp["b"]
            if i < n_layers - 1:
                h = _dropout(F.relu(h), self.dropout_rate, gen, train)
        return h, h


# ----------------------------------------------------------------------------
# GraphSAGE (mean aggregator; reference: gnn_zoo.py:88-109)
# ----------------------------------------------------------------------------


class GraphSAGE(BaseZooModel):
    name = "GraphSAGE"

    def __init__(self, edge_index, num_nodes, in_dim, hidden_dim, out_dim,
                 num_layers=2, dropout_rate=0.5, edge_weight=None, device="cuda"):
        super().__init__(edge_index, num_nodes, edge_weight, hidden_dim, device)
        self.dims = _stack_dims(in_dim, hidden_dim, out_dim, num_layers)
        self.dropout_rate = dropout_rate
        self.adj = _mean_adj(edge_index, num_nodes, hidden_dim, self.device)

    def init_params(self, gen):
        layers = []
        for i in range(len(self.dims) - 1):
            shape = (self.dims[i], self.dims[i + 1])
            layers.append({"w_nbr": _glorot(gen, shape, self.device),
                           "b_nbr": self._zeros(self.dims[i + 1]),
                           "w_root": _glorot(gen, shape, self.device)})
        return {"layers": layers}

    def apply(self, params, x, train=False, gen=None):
        h = x
        n_layers = len(params["layers"])
        for i, lp in enumerate(params["layers"]):
            h = propagate(self.adj, h) @ lp["w_nbr"] + lp["b_nbr"] + h @ lp["w_root"]
            if i < n_layers - 1:
                h = _dropout(F.relu(h), self.dropout_rate, gen, train)
        return h, h


# ----------------------------------------------------------------------------
# GAT (reference: gnn_zoo.py:59-85)
# ----------------------------------------------------------------------------


class GAT(BaseZooModel):
    name = "GAT"

    def __init__(self, edge_index, num_nodes, in_dim, hidden_dim, out_dim,
                 heads=8, num_layers=2, dropout_rate=0.6, edge_weight=None, device="cuda"):
        super().__init__(edge_index, num_nodes, edge_weight, hidden_dim, device)
        self.heads = heads
        self.dropout_rate = dropout_rate
        # Self-loops (PyG GATConv default add_self_loops=True), edges sorted
        # by target as in the JAX package.
        src = np.concatenate([edge_index[0], np.arange(num_nodes)]).astype(np.int32)
        tgt = np.concatenate([edge_index[1], np.arange(num_nodes)]).astype(np.int32)
        order = np.argsort(tgt, kind="stable")
        self.src = torch.from_numpy(src[order].astype(np.int64)).to(self.device)
        self.tgt = torch.from_numpy(tgt[order].astype(np.int64)).to(self.device)
        # Layer shapes: in->hidden (H heads, concat), ..., hidden*H->out (1 head).
        if num_layers == 1:
            self.layer_specs = [(in_dim, out_dim, heads, False)]
        else:
            specs = [(in_dim, hidden_dim, heads, True)]
            for _ in range(num_layers - 2):
                specs.append((hidden_dim * heads, hidden_dim, heads, True))
            specs.append((hidden_dim * heads, out_dim, 1, False))
            self.layer_specs = specs

    def init_params(self, gen):
        layers = []
        for din, dout, h, concat in self.layer_specs:
            layers.append({
                "w": _glorot(gen, (din, h * dout), self.device),
                "att_src": _glorot(gen, (1, h, dout), self.device),
                "att_dst": _glorot(gen, (1, h, dout), self.device),
                "b": self._zeros(h * dout if concat else dout),
            })
        return {"layers": layers}

    def _gat_layer(self, lp, x, heads, dout, concat, train, gen):
        n = x.shape[0]
        z = (x @ lp["w"]).reshape(n, heads, dout)
        a_src = torch.sum(z * lp["att_src"], dim=-1)  # [N, H]
        a_dst = torch.sum(z * lp["att_dst"], dim=-1)
        logits = F.leaky_relu(a_src[self.src] + a_dst[self.tgt], negative_slope=0.2)  # [E, H]
        alpha = segment_softmax(logits, self.tgt, n)
        # Dropout on the attention coefficients (the input's is folded in).
        alpha = _dropout(alpha, self.dropout_rate, gen, train)
        msgs = z[self.src] * alpha[:, :, None]  # [E, H, dout]
        out = msgs.new_zeros((n, heads, dout)).index_add_(0, self.tgt, msgs)
        out = out.reshape(n, heads * dout) if concat else out.mean(dim=1)
        return out + lp["b"]

    def apply(self, params, x, train=False, gen=None):
        h = x
        n_layers = len(params["layers"])
        for i, (lp, (_, dout, heads, concat)) in enumerate(zip(params["layers"],
                                                                self.layer_specs)):
            h = self._gat_layer(lp, h, heads, dout, concat, train, gen)
            if i < n_layers - 1:
                h = F.elu(h)
        return h, h


# ----------------------------------------------------------------------------
# GIN (reference: gnn_zoo.py:211-237)
# ----------------------------------------------------------------------------


class GIN(BaseZooModel):
    name = "GIN"

    def __init__(self, edge_index, num_nodes, in_dim, hidden_dim, out_dim,
                 num_layers=2, dropout_rate=0.5, edge_weight=None, device="cuda"):
        super().__init__(edge_index, num_nodes, edge_weight, hidden_dim, device)
        self.dropout_rate = dropout_rate
        self.hidden = hidden_dim
        self.dims = []
        current = in_dim
        for i in range(num_layers):
            out = hidden_dim if i < num_layers - 1 else out_dim
            self.dims.append((current, hidden_dim, out))
            current = out
        self.adj = _sum_adj(edge_index, None, num_nodes, hidden_dim, self.device)

    def init_params(self, gen):
        layers = []
        for din, dh, dout in self.dims:
            layers.append({
                "w1": _glorot(gen, (din, dh), self.device),
                "b1": self._zeros(dh),
                "w2": _glorot(gen, (dh, dout), self.device),
                "b2": self._zeros(dout),
                "eps": torch.zeros((), device=self.device),  # train_eps=True, init 0
            })
        return {"layers": layers}

    def apply(self, params, x, train=False, gen=None):
        h = x
        n_layers = len(params["layers"])
        for i, lp in enumerate(params["layers"]):
            agg = (1.0 + lp["eps"]) * h + propagate(self.adj, h)
            h = F.relu(agg @ lp["w1"] + lp["b1"]) @ lp["w2"] + lp["b2"]
            if i < n_layers - 1:
                h = _dropout(F.relu(h), self.dropout_rate, gen, train)
        return h, h


# ----------------------------------------------------------------------------
# ChebNet (reference: gnn_zoo.py:146-167)
# ----------------------------------------------------------------------------


class ChebNet(BaseZooModel):
    name = "ChebNet"

    def __init__(self, edge_index, num_nodes, in_dim, hidden_dim, out_dim,
                 K=3, num_layers=2, dropout_rate=0.5, edge_weight=None, device="cuda"):
        super().__init__(edge_index, num_nodes, edge_weight, hidden_dim, device)
        self.K = K
        self.dims = _stack_dims(in_dim, hidden_dim, out_dim, num_layers)
        self.dropout_rate = dropout_rate
        self.lap = _cheb_operator(edge_index, edge_weight, num_nodes, hidden_dim, self.device)

    def init_params(self, gen):
        return {"layers": [
            {"ws": [_glorot(gen, (self.dims[i], self.dims[i + 1]), self.device)
                    for _ in range(self.K)],
             "b": self._zeros(self.dims[i + 1])}
            for i in range(len(self.dims) - 1)]}

    def apply(self, params, x, train=False, gen=None):
        h = x
        n_layers = len(params["layers"])
        for i, lp in enumerate(params["layers"]):
            t_prev_prev = h
            out = t_prev_prev @ lp["ws"][0]
            if self.K > 1:
                t_prev = propagate(self.lap, h)
                out = out + t_prev @ lp["ws"][1]
                for j in range(2, self.K):
                    t_cur = 2.0 * propagate(self.lap, t_prev) - t_prev_prev
                    out = out + t_cur @ lp["ws"][j]
                    t_prev_prev, t_prev = t_prev, t_cur
            h = out + lp["b"]
            if i < n_layers - 1:
                h = _dropout(F.relu(h), self.dropout_rate, gen, train)
        return h, h


# ----------------------------------------------------------------------------
# RGCN (single relation; reference: gnn_zoo.py:240-267)
# ----------------------------------------------------------------------------


class RGCN(BaseZooModel):
    name = "RGCN"

    def __init__(self, edge_index, num_nodes, in_dim, hidden_dim, out_dim,
                 num_relations=1, num_layers=2, dropout_rate=0.5, edge_weight=None,
                 device="cuda"):
        super().__init__(edge_index, num_nodes, edge_weight, hidden_dim, device)
        self.dims = _stack_dims(in_dim, hidden_dim, out_dim, num_layers)
        self.dropout_rate = dropout_rate
        self.adj = _mean_adj(edge_index, num_nodes, hidden_dim, self.device)  # aggr='mean'

    def init_params(self, gen):
        layers = []
        for i in range(len(self.dims) - 1):
            shape = (self.dims[i], self.dims[i + 1])
            layers.append({"w_rel": _glorot(gen, shape, self.device),
                           "w_root": _glorot(gen, shape, self.device),
                           "b": self._zeros(self.dims[i + 1])})
        return {"layers": layers}

    def apply(self, params, x, train=False, gen=None):
        h = x
        n_layers = len(params["layers"])
        for i, lp in enumerate(params["layers"]):
            h = propagate(self.adj, h) @ lp["w_rel"] + h @ lp["w_root"] + lp["b"]
            if i < n_layers - 1:
                h = _dropout(F.relu(h), self.dropout_rate, gen, train)
        return h, h


# ----------------------------------------------------------------------------
# TongDiGCN (two-GCN directed baseline; reference: gnn_zoo.py:112-143)
# ----------------------------------------------------------------------------


class TongDiGCN(BaseZooModel):
    name = "TongDiGCN"

    def __init__(self, edge_index, num_nodes, in_dim, hidden_dim, out_dim,
                 num_layers=2, dropout_rate=0.5, edge_weight=None, device="cuda"):
        super().__init__(edge_index, num_nodes, edge_weight, hidden_dim, device)
        self.dropout_rate = dropout_rate
        self.fwd = GCN(edge_index, num_nodes, in_dim, hidden_dim, hidden_dim,
                       num_layers, dropout_rate, edge_weight, self.device)
        self.bwd = GCN(edge_index[[1, 0]], num_nodes, in_dim, hidden_dim, hidden_dim,
                       num_layers, dropout_rate, edge_weight, self.device)
        self.hidden_dim = hidden_dim
        self.out_dim = out_dim

    def init_params(self, gen):
        return {
            "fwd": self.fwd.init_params(gen),
            "bwd": self.bwd.init_params(gen),
            "w_final": _glorot(gen, (2 * self.hidden_dim, self.out_dim), self.device),
            "b_final": self._zeros(self.out_dim),
        }

    def apply(self, params, x, train=False, gen=None):
        h_fwd, _ = self.fwd.apply(params["fwd"], x, train, gen)
        h_bwd, _ = self.bwd.apply(params["bwd"], x, train, gen)
        combined = torch.cat([h_fwd, h_bwd], dim=-1)
        combined = _dropout(combined, self.dropout_rate, gen, train)
        return combined @ params["w_final"] + params["b_final"], combined


ZOO_MODELS = {
    "GCN": GCN,
    "GAT": GAT,
    "GraphSAGE": GraphSAGE,
    "GIN": GIN,
    "ChebNet": ChebNet,
    "RGCN": RGCN,
    "TongDiGCN": TongDiGCN,
}
