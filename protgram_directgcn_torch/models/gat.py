"""GAT (Velickovic et al., "Graph Attention Networks", ICLR 2018,
arXiv:1710.10903), the inductive PPI model of its Section 3.3, as a level
model of the hierarchical trainer (``gcn.architecture = "gat"``).

Layer equations (PyG ``GATConv``, as ``models/zoo.py``'s GAT):

- ``z = x W`` viewed [N, H, F];
- ``e_ij = LeakyReLU_0.2(<a_src_h, z_jh> + <a_dst_h, z_ih>)`` over the
  in-edges j -> i of each target and one self loop a node;
- ``alpha`` the softmax of ``e`` over each target's in-edges;
- ``out_i = sum_j alpha_ij z_j``, then ``+ b``.

The stack of the authors' PPI model (github.com/PetarV-/GAT,
``execute_ppi.py``, ``models/gat.py``): ``gcn.hidden_layer_dims`` are the
hidden layers' widths a head ([256, 256]) and ``gcn.gat_heads`` the heads of
every layer, the output layer's last ([4, 4, 6]).  Hidden layers concatenate
their heads and take ELU; every hidden layer after the first adds a
learned linear skip of its input (with a bias: the
authors' per-head ``conv1d``, side by side); the output layer averages its
heads into the class logits.  No dropout (the authors' PPI run has none).
Departures, as the benchmark's configuration lists them: the attention
vectors carry no bias (PyG), and the initialisation is PyG's (glorot on
``W``, on the attention vectors [H, F] and on the skip; zero biases).

The attention runs through ``ops/gat_kernels.py`` over the level's
``GatTable``.  ``<a_src_h, z_jh>`` and ``<a_dst_h, z_ih>`` are the
elementwise product and sum over each head's features, forward and (by
autograd) backward: PyG's form, ``models/zoo.py``'s and the benchmark
reference's.  A product of z with the block-diagonal matrix of the attention
vectors is as sound, but its logits differ from the reference's in the last
bit, so the few within ~3e-7 of zero may take the other branch of the
LeakyReLU; at the n = 4 level one such logit at a target of in-degree 3
moved the first gradient by 3.7e-5 of the median leaf (PERF.md §2).  This
form gives the first layer's logits bit for bit as the reference does.
Parameters: ``{"layers": [{"w", "att_src", "att_dst", "b"[, "res_w",
"res_b"]}, ...]}``, weights [in, out] applied as ``x @ w``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from protgram_directgcn_torch.ops.gat_kernels import GatTable, gat_attention

Params = Dict[str, Any]
_L2_EPS = 1e-12  # the embeddings' norm floor, DirectGCN's


class LayerSpec(NamedTuple):
    in_dim: int
    heads: int
    width: int  # features a head
    concat: bool  # hidden layers: heads side by side; the output layer: their mean
    residual: bool


@dataclasses.dataclass(frozen=True)
class GATConfig:
    """A level's GAT: input width, hidden widths a head, heads of every layer
    (one more than the hidden layers), classes."""

    in_dim: int
    hidden_dims: Tuple[int, ...]
    heads: Tuple[int, ...]
    num_classes: int

    def __post_init__(self):
        if len(self.heads) != len(self.hidden_dims) + 1 or min(self.heads, default=0) < 1:
            raise ValueError(f"gcn.gat_heads={list(self.heads)} must give the heads of each of "
                             f"the {len(self.hidden_dims)} hidden layers and of the output layer")

    def layers(self) -> List[LayerSpec]:
        specs, fin = [], self.in_dim
        for i, (h, f) in enumerate(zip(self.heads, self.hidden_dims)):
            specs.append(LayerSpec(fin, h, f, True, i > 0))
            fin = h * f
        specs.append(LayerSpec(fin, self.heads[-1], self.num_classes, False, False))
        return specs


def _glorot(gen: torch.Generator, shape, fan_in: int, fan_out: int, device) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * limit


def init_gat_params(gen: torch.Generator, cfg: GATConfig, device="cuda") -> Params:
    """Parameters drawn from ``gen`` (on ``device``), layer by layer in the
    order ``w``, ``att_src``, ``att_dst``, ``res_w``."""
    layers = []
    for s in cfg.layers():
        hf = s.heads * s.width
        lp = {"w": _glorot(gen, (s.in_dim, hf), s.in_dim, hf, device),
              "att_src": _glorot(gen, (s.heads, s.width), s.heads, s.width, device),
              "att_dst": _glorot(gen, (s.heads, s.width), s.heads, s.width, device),
              "b": torch.zeros(hf if s.concat else s.width, device=device)}
        if s.residual:
            lp["res_w"] = _glorot(gen, (s.in_dim, hf), s.in_dim, hf, device)
            lp["res_b"] = torch.zeros(hf, device=device)
        layers.append(lp)
    return {"layers": layers}


def gat_layer(lp: Params, h: torch.Tensor, table: GatTable, spec: LayerSpec) -> torch.Tensor:
    n = h.shape[0]
    z = h @ lp["w"]
    zh = z.reshape(n, spec.heads, spec.width)
    a_src = (zh * lp["att_src"]).sum(-1)
    a_dst = (zh * lp["att_dst"]).sum(-1)
    out = gat_attention(z, a_src, a_dst, table)
    if not spec.concat:
        out = out.reshape(n, spec.heads, spec.width).mean(1)
    out = out + lp["b"]
    if spec.residual:
        out = out + (h @ lp["res_w"] + lp["res_b"])
    return out


def gat_apply(params: Params, table: GatTable, x: torch.Tensor, cfg: GATConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-softmax of the class logits [N, C], the last hidden layer's
    activations L2-normalised [N, H*F]), in f32."""
    specs = cfg.layers()
    h, hidden = x.float(), x.float()
    for i, (lp, spec) in enumerate(zip(params["layers"], specs)):
        out = gat_layer(lp, h, table, spec)
        if i < len(specs) - 1:
            h = hidden = F.elu(out)
    emb = hidden / (torch.linalg.vector_norm(hidden, dim=-1, keepdim=True) + _L2_EPS)
    return F.log_softmax(out, dim=-1), emb


def param_count(cfg: GATConfig) -> int:
    """Elements of the parameters."""
    total = 0
    for s in cfg.layers():
        hf = s.heads * s.width
        total += s.in_dim * hf + 2 * hf + (hf if s.concat else s.width)
        if s.residual:
            total += s.in_dim * hf + hf
    return total
