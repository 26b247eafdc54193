"""DirectGCN: dual-path directed GCN with hierarchical gating.

Port of protgram_directgcn_tpu/models/directgcn.py:36-298, 299-430, 431-687
(reference: src/models/protgram_directgcn.py:20-222).  Parameters are a
plain dict of tensors with the JAX package's names and layout (weights stored
[in, out] and applied as ``x @ w``), so ``convert.params_from_jax`` maps one
onto the other leaf by leaf.

Per layer: one fused projection per path, ``x @ (W_main + W_shared)``, then
one propagation per edge set (propagation is linear, so
P(X·W_main) + P(X·W_shared) == P(X·(W_main + W_shared))), the per-path biases
``b_main + b_shared``, and the hierarchical gates and per-node constant.
From the propagated paths to the activation (with the residual, leaky ReLU
and dropout) a layer with no feature shard runs one op,
``ops/epilogue_kernels.layer_tail``: a CUDA kernel each way on float32
tensors on the card, the plain ATen chain elsewhere.  On
hypercube levels the carry stays in the kernels' rg layout [A, G, F] through
every layer; per-node parameters are viewed [A, G, ·] to match (a constant
may also be stored rg, as the trainer does on those levels).  A Cluster-GCN
batch passes ``original_indices``: the per-node parameters are gathered at
the batch's node ids.

The memory tiers of the trainer's plan set four fields of the config, with
the JAX package's numerics: ``compute_dtype="bfloat16"`` runs projections,
propagations, the residual, the inter-layer carry and the decoder in bf16
(biases and residual weights cast to the carry type, softmax and the
embedding norm in f32); ``node_param_dtype="bfloat16"`` stores the gates and
constants in bf16; ``remat`` recomputes each layer and the decoder in the
backward pass (``torch.utils.checkpoint``); ``remat_paths`` recomputes each
of a layer's three gated paths on its own and, on an rg carry, packs a
sub-128-wide layer output through the retile kernels (ops/retile.py).
Dropout masks come from per-layer seeds drawn once per forward pass, so a
recompute replays the forward's masks.  ``apply_layer_range`` runs a slice
of the stack and ``apply_decoder`` the head, so that the trainer's
layer-staged step (memory tier 4) can run one layer at a time;
``fused=False`` is the literal 6-propagation layer (a parity reference).
Not ported: the JAX package's manual per-path VJP with its optimisation
barriers (the torch staged step recomputes a layer with autograd instead)
and the TPU's 128-lane weight padding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from protgram_directgcn_torch.ops import epilogue_kernels, retile
from protgram_directgcn_torch.ops.hypercube import HypercubeAdj
from protgram_directgcn_torch.ops.spmm import propagate, propagate3

Params = Dict[str, Any]

_GATES = ("c_in", "c_out", "c_directed", "c_undirected", "c_all")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    fused: bool = True  # False: the literal 6-propagation layer (directgcn.py:279-294)
    remat: bool = False  # recompute each layer and the decoder in the backward
    remat_paths: bool = False  # recompute per path; pack sub-128 rg carries
    compute_dtype: str = "float32"  # or "bfloat16"
    node_param_dtype: str = "float32"  # gates and constants; or "bfloat16"

    def __post_init__(self):
        if len(self.layer_dims) < 2:
            raise ValueError("layer_dims must contain at least input and output dims")
        for name in ("compute_dtype", "node_param_dtype"):
            if getattr(self, name) not in _DTYPES:
                raise ValueError(f"{name} must be one of {sorted(_DTYPES)}")


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


def _init_layer(gen, in_dim, out_dim, num_nodes, use_vector_coeffs, device,
                node_dtype) -> Params:
    p: Params = {
        name: _xavier_uniform(gen, (in_dim, out_dim), in_dim, out_dim, device)
        for name in ("w_main_in", "w_main_out", "w_und", "w_shared")
    }
    for name in ("b_main_in", "b_main_out", "b_und", "b_shared_in", "b_shared_out", "b_shared_und"):
        p[name] = torch.zeros(out_dim, device=device)
    gate_shape = (num_nodes, 1) if (use_vector_coeffs and num_nodes > 0) else (1,)
    for name in _GATES:
        p[name] = torch.ones(gate_shape, device=device, dtype=node_dtype)
    # torch xavier on [N, out]: fan_in = out, fan_out = N (protgram_directgcn.py:90-91),
    # drawn in f32 and stored in the node dtype (directgcn.py:139-151).
    p["constant"] = (
        _xavier_uniform(gen, (num_nodes, out_dim), out_dim, num_nodes, device).to(node_dtype)
        if num_nodes > 0 else None
    )
    return p


def init_directgcn_params(gen: torch.Generator, cfg: DirectGCNConfig,
                          device="cuda") -> Params:
    """Parameters drawn from ``gen`` (a ``torch.Generator`` on ``device``)
    with the reference's init distributions; gates and constants in
    ``cfg.node_param_dtype``.  The draws differ from the JAX package's:
    carry parameters across with ``convert.params_from_jax``."""
    dims = cfg.layer_dims
    node_dtype = _DTYPES[cfg.node_param_dtype]
    layers: List[Params] = []
    res_projs: List[Optional[Dict[str, torch.Tensor]]] = []
    for i in range(len(dims) - 1):
        layers.append(_init_layer(gen, dims[i], dims[i + 1], cfg.num_nodes,
                                  cfg.use_vector_coeffs and cfg.num_nodes > 0, device,
                                  node_dtype))
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
    return [t for _, t in named_leaves(params)]


def named_leaves(params: Params) -> List[Tuple[str, torch.Tensor]]:
    """(name of the innermost dict key, tensor) for every tensor of a
    parameter tree, in :func:`param_leaves`' order."""
    out: List[Tuple[str, torch.Tensor]] = []
    _walk_leaves(params, "", out)
    return out


def _walk_leaves(t, name: str, out: list) -> None:
    # Module level, not a closure: a recursive closure over ``out`` is a
    # reference cycle that keeps every parameter alive until the garbage
    # collector runs (a finished level's node tables stayed on the card).
    if isinstance(t, torch.Tensor):
        out.append((name, t))
    elif isinstance(t, dict):
        for k in sorted(t):
            _walk_leaves(t[k], k, out)
    elif isinstance(t, (list, tuple)):
        for v in t:
            _walk_leaves(v, name, out)


# ----------------------------------------------------------------------------
# Carry packing (directgcn.py:476-508)
# ----------------------------------------------------------------------------


def pack_rg_carry(t: torch.Tensor, active: bool = True) -> torch.Tensor:
    """Pack an rg carry ``[A, G, f]`` of a width f in ``retile.WIDTHS`` to
    128-wide rows ``[A, ceil(G/k), 128]``, k = 128 / f, G zero-padded to a
    multiple of k; other carries are returned as they are."""
    if not active or t.dim() != 3 or t.shape[-1] not in retile.WIDTHS:
        return t
    a, g, f = t.shape
    k = retile.LANES // f
    gp = -(-g // k) * k
    if gp != g:
        t = F.pad(t, (0, 0, 0, gp - g))
    return retile.pack_rg(t, f)


def unpack_rg_carry(t: torch.Tensor, f: int, g_real: int) -> torch.Tensor:
    """Inverse of :func:`pack_rg_carry` (no-op on an unpacked carry)."""
    if t.dim() != 3 or t.shape[-1] == f:
        return t
    return retile.unpack_pad_rg(t, f)[:, :g_real, :f]


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------


def _maybe_checkpoint(active: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward pass when ``active`` and
    autograd is recording."""
    if active and torch.is_grad_enabled():
        # The dropout masks come from explicit seeds: no global RNG state to replay.
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _rg_view(lead, t):
    """A flat per-node table ``[N, ·]`` viewed ``[A, G, ·]``; an rg table or
    a scalar gate as it is."""
    return t.reshape(tuple(lead) + tuple(t.shape[-1:])) if getattr(t, "dim", lambda: 0)() == 2 else t


def _gather_node_params(p: Params, original_indices: Optional[torch.Tensor]):
    """The per-node gates and constant, gathered at a subgraph batch's
    original node ids (directgcn.py:188-201; reference:
    protgram_directgcn.py:116-128).  A constant stored rg ``[A, G, out]``
    is flattened first.  With ``original_indices=None``, or scalar gates,
    the tables as they are."""
    if original_indices is not None and p["c_in"].dim() == 2:
        gates = tuple(p[n][original_indices] for n in _GATES)
        const = p["constant"]
        if const is not None and const.dim() == 3:
            const = const.reshape(-1, const.shape[-1])
        const = const[original_indices] if const is not None else 0.0
    else:
        gates = tuple(p[n] for n in _GATES)
        const = p["constant"] if p["constant"] is not None else 0.0
    return gates, const


def _node_params(p: Params, x: torch.Tensor, width: int,
                 original_indices: Optional[torch.Tensor] = None, feat=None):
    """The gates and constant as the paths take them: gathered at a batch's
    node ids, the constant cut to this feature shard's ``width`` columns
    (``feat``), and viewed rg ``[A, G, ·]`` on an rg carry ``x``."""
    gates, const = _gather_node_params(p, original_indices)
    if feat is not None and isinstance(const, torch.Tensor):
        const = const[..., feat.cols(width)]
    if x.dim() == 3:
        lead = x.shape[:2]
        gates = tuple(_rg_view(lead, t) for t in gates)
        const = _rg_view(lead, const)
    return gates, const


def _combine_paths(p: Params, x: torch.Tensor, ic, oc, uc,
                   original_indices: Optional[torch.Tensor] = None, feat=None) -> torch.Tensor:
    """Hierarchical gating + per-node constant
    (reference combine: protgram_directgcn.py:131-135).  ``feat``: the paths
    hold this feature shard's columns, and so does the constant's share."""
    gates, const = _node_params(p, x, ic.shape[-1], original_indices, feat)
    return epilogue_kernels.combine_plain(gates, ic, oc, uc, const)


def _propagated_paths(p: Params, graph, xc: torch.Tensor, ct: torch.dtype):
    """The three paths' fused projections, propagated (one product each)."""
    x_in = xc @ (p["w_main_in"] + p["w_shared"]).to(ct)
    x_out = xc @ (p["w_main_out"] + p["w_shared"]).to(ct)
    x_und = xc @ (p["w_und"] + p["w_shared"]).to(ct)
    return propagate3(graph, x_in, x_out, x_und)


def _bias_sums(p: Params, ct: torch.dtype):
    """The paths' bias sums in the compute type, so that under bf16 the adds
    keep the propagated paths bf16 (directgcn.py:263-269)."""
    return ((p["b_main_in"] + p["b_shared_in"]).to(ct),
            (p["b_main_out"] + p["b_shared_out"]).to(ct),
            (p["b_und"] + p["b_shared_und"]).to(ct))


def _layer_apply(p: Params, graph, x: torch.Tensor, cfg: DirectGCNConfig,
                 original_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused DirectGCN layer (reference forward: protgram_directgcn.py:93-135;
    JAX directgcn.py:206-296).  ``original_indices``: a subgraph batch's
    node ids in the level's node space (Cluster-GCN), or None."""
    ct = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else x.dtype
    xc = x.to(ct)
    if not cfg.fused:
        return _layer_literal(p, graph, xc, ct, original_indices)
    if x.dim() == 3 and cfg.remat_paths:
        return _layer_paths_remat(p, graph, xc, cfg, ct, original_indices)
    pi, po, pu = _propagated_paths(p, graph, xc, ct)
    b_in, b_out, b_und = _bias_sums(p, ct)
    return _combine_paths(p, x, pi + b_in, po + b_out, pu + b_und, original_indices,
                          getattr(graph, "feat", None))


def _residual(rp: Optional[Params], h: torch.Tensor, feat=None, width: int = 0) -> torch.Tensor:
    """The residual branch, its weights cast to the carry type
    (directgcn.py:547-551); an identity one on feature shards (``feat``)
    keeps this shard's ``width`` columns."""
    if rp is not None:
        return h @ rp["w"].to(h.dtype) + rp["b"].to(h.dtype)
    return h if feat is None else h[..., feat.cols(width)]


def _layer_tail(p: Params, rp: Optional[Params], graph, x: torch.Tensor, cfg: DirectGCNConfig,
                seed: Optional[int],
                original_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A fused layer through its activation: the projections and
    propagations, then the bias adds, gating, constant, residual (``rp``),
    leaky ReLU and dropout (mask from ``seed``; None: none) in one op,
    ``epilogue_kernels.layer_tail``."""
    ct = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else x.dtype
    pi, po, pu = _propagated_paths(p, graph, x.to(ct), ct)
    gates, const = _node_params(p, x, pi.shape[-1], original_indices)
    u = _uniforms(pi.shape, seed, pi.device) if seed is not None else None
    return epilogue_kernels.layer_tail(pi, po, pu, *_bias_sums(p, ct), gates, const,
                                       _residual(rp, x), cfg.leaky_relu_slope,
                                       1.0 - cfg.dropout, u)


def _layer_literal(p: Params, graph, xc: torch.Tensor, ct: torch.dtype,
                   original_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The literal dataflow (directgcn.py:279-294): each path propagates its
    main and its shared projection on their own, 6 propagations a layer."""
    xs = xc @ p["w_shared"].to(ct)

    def path(adj, w_main, b_main, b_shared):
        return ((propagate(adj, xc @ p[w_main].to(ct)) + p[b_main].to(ct))
                + (propagate(adj, xs) + p[b_shared].to(ct)))

    ic = path(graph.p_in, "w_main_in", "b_main_in", "b_shared_in")
    oc = path(graph.p_out, "w_main_out", "b_main_out", "b_shared_out")
    uc = path(graph.p_und, "w_und", "b_und", "b_shared_und")
    return _combine_paths(p, xc, ic, oc, uc, original_indices, getattr(graph, "feat", None))


def _layer_paths_remat(p: Params, graph, xc: torch.Tensor, cfg: DirectGCNConfig,
                       ct: torch.dtype,
                       original_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """rg-layout layer with each gated path recomputed on its own
    (directgcn.py:299-430):

        out = (c_all·c_dir·c_in)·IC + (c_all·c_dir·c_out)·OC
            + (c_all·c_und)·UC + const

    The gate product is folded into each path's checkpoint, so the backward
    needs one path's propagated output at a time for its gate gradient."""
    lead = xc.shape[:2]
    (c_in, c_out, c_dir, c_und, c_all), const = _gather_node_params(p, original_indices)
    gate_in = _rg_view(lead, c_dir * c_all * c_in)
    gate_out = _rg_view(lead, c_dir * c_all * c_out)
    gate_und = _rg_view(lead, c_und * c_all)
    const = _rg_view(lead, const)

    def path(adj):
        def contrib(w, b, gate, xv):
            y = propagate(adj, xv @ w.to(ct))
            return gate.to(ct) * (y + b.to(ct))
        return contrib

    acc = _maybe_checkpoint(True, path(graph.p_in), p["w_main_in"] + p["w_shared"],
                            p["b_main_in"] + p["b_shared_in"], gate_in, xc)
    acc = acc + _maybe_checkpoint(True, path(graph.p_out), p["w_main_out"] + p["w_shared"],
                                  p["b_main_out"] + p["b_shared_out"], gate_out, xc)
    acc = acc + _maybe_checkpoint(True, path(graph.p_und), p["w_und"] + p["w_shared"],
                                  p["b_und"] + p["b_shared_und"], gate_und, xc)
    return acc + const


def _uniforms(shape, seed: int, device) -> torch.Tensor:
    """The uniforms of a dropout mask drawn from ``seed``: the same seed gives
    the same mask, so a recompute replays the forward's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device)


def _dropout(t: torch.Tensor, rate: float, seed: int, feat=None) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``seed``.  ``feat``: ``t``
    holds a feature shard's columns; the mask is the whole rows' one, cut."""
    keep = 1.0 - rate
    shape = t.shape if feat is None else t.shape[:-1] + (t.shape[-1] * feat.shards,)
    mask = _uniforms(shape, seed, t.device) < keep
    if feat is not None:
        mask = mask[..., feat.cols(t.shape[-1])]
    return torch.where(mask, t / keep, torch.zeros((), dtype=t.dtype, device=t.device))


def dropout_seeds(gen: Optional[torch.Generator], count: int) -> List[Optional[int]]:
    """One mask seed per layer and one for the decoder, drawn from ``gen``
    (None: no dropout)."""
    if gen is None:
        return [None] * count
    return torch.randint(0, 2**62, (count,), generator=gen, device=gen.device).tolist()


def apply_layer_range(params: Params, graph, h: torch.Tensor, cfg: DirectGCNConfig,
                      start: int, stop: int, *, train: bool, seeds: Sequence[Optional[int]],
                      rg_lead: Optional[Tuple[int, int]] = None,
                      original_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GCN layers ``[start, stop)`` on a flat or rg carry: layer, residual,
    leaky ReLU, dropout (directgcn.py:512-581).  Under ``cfg.remat_paths``
    an rg carry of a width in ``retile.WIDTHS`` leaves a layer packed, and
    the next layer (or the caller) unpacks it, so a slice hands over and
    takes packed carries.  ``seeds`` holds the whole net's seeds (one a
    layer, then the decoder's), so that a slice drops what the whole stack
    drops.  ``original_indices``: see :func:`_layer_apply`.  On feature
    shards (``graph.feat``) a layer computes this rank's columns and the
    carry is gathered to whole rows before the activation."""
    ct = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    pack = cfg.remat_paths and rg_lead is not None
    feat = getattr(graph, "feat", None)

    def layer_block(layer_p, rp, hh, seed):
        if pack:
            hh = unpack_rg_carry(hh, layer_p["w_main_in"].shape[0], rg_lead[1])
        seed = seed if train and cfg.dropout > 0 else None
        if cfg.fused and feat is None and not (hh.dim() == 3 and cfg.remat_paths):
            # The three-path layer with no gather before its activation: its
            # whole tail in one op (the kernels where they apply).
            out = _layer_tail(layer_p, rp, graph, hh, cfg, seed, original_indices)
            return out.to(ct) if ct is not None else out
        gcn_out = _layer_apply(layer_p, graph, hh, cfg, original_indices)
        s = gcn_out + _residual(rp, hh, feat, gcn_out.shape[-1])
        if feat is not None:
            s = feat.gather(s)
        # Pack before the activation tail: packing is a permutation with zero
        # pad slots, which leaky ReLU and dropout keep zero (directgcn.py:556-561).
        s = pack_rg_carry(s, pack)
        u = _uniforms(s.shape, seed, s.device) if seed is not None else None
        out = epilogue_kernels.activate_plain(s, cfg.leaky_relu_slope, 1.0 - cfg.dropout, u)
        return out.to(ct) if ct is not None else out

    for i in range(start, stop):
        h = _maybe_checkpoint(cfg.remat, layer_block, params["layers"][i],
                              params["res_projs"][i], h, seeds[i])
    return h


def apply_decoder(dec_p: Params, h: torch.Tensor, cfg: DirectGCNConfig, *, train: bool,
                  seed: Optional[int], feat=None) -> torch.Tensor:
    """The 2-layer decoder head in the carry type
    (reference: protgram_directgcn.py:173-180; directgcn.py:584-606).  On
    feature shards (``feat``) ``relu(h @ w1[:, cols] + b1[cols]) @
    w2[cols, :]`` is summed over the shards, ``b2`` counted on rank 0's."""

    def block(dp, hh):
        z = F.relu(hh @ dp["w1"].to(hh.dtype) + dp["b1"].to(hh.dtype))
        if train and seed is not None and cfg.decoder_dropout > 0:
            z = _dropout(z, cfg.decoder_dropout, seed, feat)
        out = z @ dp["w2"].to(z.dtype)
        if feat is None:
            return out + dp["b2"].to(z.dtype)
        # b2 counts once in the sum; it enters every rank's graph, so that
        # every rank's leaves hold a gradient to reduce.
        return feat.sum(out + dp["b2"].to(z.dtype) * (1.0 if feat.rank == 0 else 0.0))

    return _maybe_checkpoint(cfg.remat, block, dec_p, h)


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
                    original_indices: Optional[torch.Tensor] = None,
                    flatten_rg: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_softmax logits, L2-normalised embeddings)
    (reference: protgram_directgcn.py:195-222).

    On hypercube graphs a flat ``[A^n, F]`` input is viewed rg ``[A, G, F]``
    (an rg input is taken as it is) and the carry stays rg through the stack;
    ``flatten_rg=False`` returns rg outputs, which the training loss uses.
    ``gen`` draws the dropout masks' seeds when ``train``.  The embeddings
    are f32; the log-softmax, computed in f32, is stored in the carry type.
    ``original_indices`` (a Cluster-GCN batch: ``graph`` is the batch's
    subgraph, ``x`` its flat rows) gathers the per-node parameters at the
    batch's node ids in the level's node space.
    """
    h = _apply_pe(params, x, cfg)
    rg_lead = None
    if original_indices is None and h.dim() == 3:
        rg_lead = tuple(h.shape[:2])
    elif (original_indices is None and isinstance(graph.p_in, HypercubeAdj)
          and h.shape[0] == graph.p_in.n_out):
        rg_lead = graph.p_in.feature_shape
        h = h.reshape(rg_lead + tuple(h.shape[-1:]))
    n_layers = len(params["layers"])
    seeds = dropout_seeds(gen if train else None, n_layers + 1)
    h = apply_layer_range(params, graph, h, cfg, 0, n_layers, train=train, seeds=seeds,
                          rg_lead=rg_lead, original_indices=original_indices)
    if rg_lead is not None:
        h = unpack_rg_carry(h, cfg.layer_dims[-1], rg_lead[1])
    logits = apply_decoder(params["decoder"], h, cfg, train=train, seed=seeds[-1],
                           feat=getattr(graph, "feat", None))
    h32 = h.float()
    normalized = h32 / (torch.linalg.vector_norm(h32, dim=-1, keepdim=True) + cfg.l2_eps)
    log_sm = F.log_softmax(logits.float(), dim=-1).to(logits.dtype)
    if rg_lead is not None and flatten_rg:
        log_sm = log_sm.reshape((-1,) + tuple(log_sm.shape[2:]))
        normalized = normalized.reshape((-1,) + tuple(normalized.shape[2:]))
    return log_sm, normalized
