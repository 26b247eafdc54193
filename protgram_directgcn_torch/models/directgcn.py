"""DirectGCN: dual-path directed GCN with hierarchical gating.

Port of protgram_directgcn_tpu/models/directgcn.py:36-298, 431-460, 584-687
(reference: src/models/protgram_directgcn.py:20-222).  Parameters are a
plain dict of tensors with the JAX package's names and layout (weights stored
[in, out] and applied as ``x @ w``), so ``convert.params_from_jax`` maps one
onto the other leaf by leaf.

Per layer: one fused projection per path, ``x @ (W_main + W_shared)``, then
one propagation per edge set (propagation is linear, so
P(X·W_main) + P(X·W_shared) == P(X·(W_main + W_shared))), the per-path biases
``b_main + b_shared``, and the hierarchical gates and per-node constant.  On
hypercube levels the carry stays in the kernels' rg layout [A, G, F] through
every layer; per-node parameters are viewed [A, G, ·] to match.

The model is float32 throughout (tier 0 of the trainer's plan).  Not ported
here: the bfloat16 compute and node-parameter tiers, the literal
6-propagation layer (``fused=False``), remat, the per-path VJP, the packed
sub-128 carry and the TPU 128-lane weight padding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from protgram_directgcn_torch.ops.hypercube import HypercubeAdj
from protgram_directgcn_torch.ops.spmm import propagate3

Params = Dict[str, Any]

_GATES = ("c_in", "c_out", "c_directed", "c_undirected", "c_all")


@dataclass(frozen=True)
class DirectGCNConfig:
    """Static model hyperparameters (names and defaults of the JAX package)."""

    layer_dims: Tuple[int, ...]  # [in, hidden..., out] (>= 2 entries)
    num_nodes: int
    num_classes: int
    n_gram_len: int
    one_gram_dim: int = 0  # > 0 only at level n=1
    max_pe_len: int = 512
    dropout: float = 0.5
    decoder_dropout: float = 0.5
    use_vector_coeffs: bool = True
    l2_eps: float = 1e-12
    leaky_relu_slope: float = 0.01
    decoder_hidden_floor: int = 1
    use_pallas: bool = False  # ELL operators run the CUDA ELL kernels (spmm.propagate)

    def __post_init__(self):
        if len(self.layer_dims) < 2:
            raise ValueError("layer_dims must contain at least input and output dims")


# ----------------------------------------------------------------------------
# Initialization (reference reset_parameters, protgram_directgcn.py:70-91)
# ----------------------------------------------------------------------------


def _uniform(gen, shape, limit, device):
    return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * limit


def _xavier_uniform(gen, shape, fan_in, fan_out, device):
    return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)), device)


def _torch_linear_init(gen, in_dim, out_dim, device):
    """nn.Linear default init (kaiming_uniform(a=sqrt(5)) + bias bound)."""
    limit = math.sqrt(1.0 / in_dim)
    return _uniform(gen, (in_dim, out_dim), limit, device), _uniform(gen, (out_dim,), limit, device)


def _init_layer(gen, in_dim, out_dim, num_nodes, use_vector_coeffs, device) -> Params:
    p: Params = {
        name: _xavier_uniform(gen, (in_dim, out_dim), in_dim, out_dim, device)
        for name in ("w_main_in", "w_main_out", "w_und", "w_shared")
    }
    for name in ("b_main_in", "b_main_out", "b_und", "b_shared_in", "b_shared_out", "b_shared_und"):
        p[name] = torch.zeros(out_dim, device=device)
    gate_shape = (num_nodes, 1) if (use_vector_coeffs and num_nodes > 0) else (1,)
    for name in _GATES:
        p[name] = torch.ones(gate_shape, device=device)
    # torch xavier on [N, out]: fan_in = out, fan_out = N (protgram_directgcn.py:90-91).
    p["constant"] = (
        _xavier_uniform(gen, (num_nodes, out_dim), out_dim, num_nodes, device)
        if num_nodes > 0 else None
    )
    return p


def init_directgcn_params(gen: torch.Generator, cfg: DirectGCNConfig,
                          device="cuda") -> Params:
    """Parameters drawn from ``gen`` (a ``torch.Generator`` on ``device``)
    with the reference's init distributions.  The draws differ from the JAX
    package's: carry parameters across with ``convert.params_from_jax``."""
    dims = cfg.layer_dims
    layers: List[Params] = []
    res_projs: List[Optional[Dict[str, torch.Tensor]]] = []
    for i in range(len(dims) - 1):
        layers.append(_init_layer(gen, dims[i], dims[i + 1], cfg.num_nodes,
                                  cfg.use_vector_coeffs and cfg.num_nodes > 0, device))
        if dims[i] != dims[i + 1]:
            w, b = _torch_linear_init(gen, dims[i], dims[i + 1], device)
            res_projs.append({"w": w, "b": b})
        else:
            res_projs.append(None)  # identity residual
    final_dim = dims[-1]
    hidden = max(final_dim // 2 if final_dim > 1 else 1, cfg.decoder_hidden_floor)
    dw1, db1 = _torch_linear_init(gen, final_dim, hidden, device)
    dw2, db2 = _torch_linear_init(gen, hidden, cfg.num_classes, device)
    params: Params = {
        "layers": layers,
        "res_projs": res_projs,
        "decoder": {"w1": dw1, "b1": db1, "w2": dw2, "b2": db2},
    }
    if cfg.one_gram_dim > 0 and cfg.max_pe_len > 0:
        # nn.Embedding default init: N(0, 1) (protgram_directgcn.py:156-158).
        params["pe_table"] = torch.randn((cfg.max_pe_len, cfg.one_gram_dim), generator=gen,
                                         device=device)
    return params


def param_leaves(params: Params) -> List[torch.Tensor]:
    """Every tensor of a parameter tree, in a fixed order."""
    out: List[torch.Tensor] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(params)
    return out


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------


def _combine_paths(p: Params, x: torch.Tensor, ic, oc, uc) -> torch.Tensor:
    """Hierarchical gating + per-node constant
    (reference combine: protgram_directgcn.py:131-135)."""
    c_in, c_out, c_dir, c_und, c_all = (p[n] for n in _GATES)
    const = p["constant"] if p["constant"] is not None else 0.0
    if x.dim() == 3:
        # rg carry: per-node params follow the same [N, ·] -> [A, G, ·] view.
        lead = tuple(x.shape[:2])

        def rg(t):
            return t.reshape(lead + tuple(t.shape[-1:])) if getattr(t, "dim", lambda: 0)() == 2 else t

        c_in, c_out, c_dir, c_und, c_all, const = map(rg, (c_in, c_out, c_dir, c_und, c_all, const))
    directed = c_dir * (c_in * ic + c_out * oc)
    undirected = c_und * uc
    return c_all * (undirected + directed) + const


def _layer_apply(p: Params, graph, x: torch.Tensor, cfg: DirectGCNConfig) -> torch.Tensor:
    """One fused DirectGCN layer (reference forward: protgram_directgcn.py:93-135)."""
    x_in = x @ (p["w_main_in"] + p["w_shared"])
    x_out = x @ (p["w_main_out"] + p["w_shared"])
    x_und = x @ (p["w_und"] + p["w_shared"])
    pi, po, pu = propagate3(graph, x_in, x_out, x_und, cfg.use_pallas)
    ic = pi + (p["b_main_in"] + p["b_shared_in"])
    oc = po + (p["b_main_out"] + p["b_shared_out"])
    uc = pu + (p["b_und"] + p["b_shared_und"])
    return _combine_paths(p, x, ic, oc, uc)


def _dropout(t: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    keep = 1.0 - rate
    mask = torch.rand(t.shape, generator=gen, device=t.device) < keep
    return torch.where(mask, t / keep, torch.zeros((), dtype=t.dtype, device=t.device))


def apply_layers(params: Params, graph, h: torch.Tensor, cfg: DirectGCNConfig, *,
                 train: bool, gen: Optional[torch.Generator]) -> torch.Tensor:
    """The GCN stack on a flat or rg carry: layer, residual, leaky ReLU,
    dropout (directgcn.py:512-581)."""
    for p, rp in zip(params["layers"], params["res_projs"]):
        gcn_out = _layer_apply(p, graph, h, cfg)
        res_out = h if rp is None else h @ rp["w"] + rp["b"]
        h = F.leaky_relu(gcn_out + res_out, negative_slope=cfg.leaky_relu_slope)
        if train and gen is not None and cfg.dropout > 0:
            h = _dropout(h, cfg.dropout, gen)
    return h


def apply_decoder(dec_p: Params, h: torch.Tensor, cfg: DirectGCNConfig, *, train: bool,
                  gen: Optional[torch.Generator]) -> torch.Tensor:
    """The 2-layer decoder head (reference: protgram_directgcn.py:173-180)."""
    z = F.relu(h @ dec_p["w1"] + dec_p["b1"])
    if train and gen is not None and cfg.decoder_dropout > 0:
        z = _dropout(z, cfg.decoder_dropout, gen)
    return z @ dec_p["w2"] + dec_p["b2"]


def _apply_pe(params: Params, x: torch.Tensor, cfg: DirectGCNConfig) -> torch.Tensor:
    """Per-slot learned positional encoding for 1-gram-composed features
    (reference: protgram_directgcn.py:182-193)."""
    if "pe_table" not in params:
        return x
    n, d1 = cfg.n_gram_len, cfg.one_gram_dim
    if n <= 0 or d1 <= 0 or x.shape[1] != n * d1:
        return x
    pos = min(n, cfg.max_pe_len)
    xr = x.reshape(-1, n, d1)
    pe = torch.zeros((n, d1), dtype=xr.dtype, device=xr.device)
    pe[:pos] = params["pe_table"][:pos]
    return (xr + pe[None]).reshape(-1, n * d1)


def directgcn_apply(params: Params, graph, x: torch.Tensor, cfg: DirectGCNConfig, *,
                    train: bool = False, gen: Optional[torch.Generator] = None,
                    flatten_rg: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_softmax logits, L2-normalised embeddings)
    (reference: protgram_directgcn.py:195-222).

    On hypercube graphs a flat ``[A^n, F]`` input is viewed rg ``[A, G, F]``
    (an rg input is taken as it is) and the carry stays rg through the stack;
    ``flatten_rg=False`` returns rg outputs, which the training loss uses.
    ``gen`` draws the dropout masks when ``train``.
    """
    h = _apply_pe(params, x, cfg)
    rg_lead = None
    if h.dim() == 3:
        rg_lead = tuple(h.shape[:2])
    elif isinstance(graph.p_in, HypercubeAdj) and h.shape[0] == graph.p_in.n_out:
        rg_lead = graph.p_in.feature_shape
        h = h.reshape(rg_lead + tuple(h.shape[-1:]))
    h = apply_layers(params, graph, h, cfg, train=train, gen=gen)
    logits = apply_decoder(params["decoder"], h, cfg, train=train, gen=gen)
    normalized = h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + cfg.l2_eps)
    log_sm = F.log_softmax(logits, dim=-1)
    if rg_lead is not None and flatten_rg:
        log_sm = log_sm.reshape((-1,) + tuple(log_sm.shape[2:]))
        normalized = normalized.reshape((-1,) + tuple(normalized.shape[2:]))
    return log_sm, normalized
