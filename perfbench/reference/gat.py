"""Plain PyTorch GAT level trained full batch with Adam: the benchmark's
reference for a configuration with ``"model": "gat"``, written from the
published model and independent of the program under test.

Model (Velickovic et al., ICLR 2018, arXiv:1710.10903, Section 3.3, the
inductive PPI model; PyG ``GATConv`` form).  A layer of H heads of width F:
``z = h W`` viewed [N, H, F]; over every edge j -> i of the level's graph
(its self loops removed, one added a node, unweighted) the logit
``e = LeakyReLU_0.2(<a_src_h, z_jh> + <a_dst_h, z_ih>)``; ``alpha`` the
softmax of ``e`` over each target's in-edges (a segment max and a segment
sum); ``out_i = sum_j alpha_ij z_j`` (``index_add_``), then the bias.
Hidden layers concatenate their heads and take ELU, and every hidden layer
after the first adds a learned linear skip of its input with a bias; the
output layer averages its heads into the class logits.  The loss is the
masked mean negative log-likelihood of the log-softmax, plus ``l2`` times
the sum of squares of every parameter; ``weight_decay`` (where ``l2`` is 0)
adds ``weight_decay * p`` to the gradient; Adam (b1 0.9, b2 0.999, eps 1e-8)
with its bias corrections computed in float32.

Every per-edge quantity is an explicit tensor.  Targets are taken in blocks
of rows whose edges hold at most ``edge_block_elements`` message elements
(``[E_block, H, F]``), each block under ``torch.utils.checkpoint``, so that a
layer's messages at the n = 4 level (13.4 GB whole) fit the card.

Drawing: from one ``torch.Generator`` on the device seeded ``seed + n``,
layer by layer, ``w`` [in, H*F], ``att_src`` and ``att_dst`` [H, F] and,
with the skip, ``res_w`` [in, H*F], each ``(rand * 2 - 1) * limit`` with
glorot's limit ``sqrt(6 / (fan_in + fan_out))`` over the shape's two dims;
biases zero.  Imports NumPy, PyTorch and this folder only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference import level as ref_level
from perfbench.reference.model import ADAM_B1, ADAM_B2, ADAM_EPS, adam_corrections, named_leaves

NEG_SLOPE = 0.2
# Message elements ([E_block, H, F]) a block of target rows may hold: 1 GB.
EDGE_BLOCK_ELEMENTS = 1 << 28


@dataclasses.dataclass(frozen=True)
class Layer:
    in_dim: int
    heads: int
    width: int
    concat: bool
    residual: bool


def layers(in_dim: int, hidden: Sequence[int], heads: Sequence[int], num_classes: int
           ) -> List[Layer]:
    out, fin = [], in_dim
    for i, (h, f) in enumerate(zip(heads, hidden)):
        out.append(Layer(fin, h, f, True, i > 0))
        fin = h * f
    out.append(Layer(fin, heads[-1], num_classes, False, False))
    return out


@dataclasses.dataclass
class GatLevel:
    """A level's edges for attention: ``src``, ``tgt`` sorted by target,
    self loops replaced by one a node; ``starts[i]`` the first edge of
    target i; ``n`` the level's n-gram length (the weights' seed is
    ``seed + n``)."""

    n: int
    num_nodes: int
    src: torch.Tensor
    tgt: torch.Tensor
    starts: torch.Tensor

    @property
    def num_edges(self) -> int:
        return int(len(self.src))


def from_edges(src: torch.Tensor, tgt: torch.Tensor, num_nodes: int, n: int) -> GatLevel:
    """The attention edges of the directed edges ``src -> tgt``: without
    their self loops, one added a node, sorted by target (duplicates kept)."""
    keep = src != tgt
    loops = torch.arange(num_nodes, device=src.device)
    src = torch.cat([src[keep], loops])
    tgt = torch.cat([tgt[keep], loops])
    order = torch.sort(tgt, stable=True).indices
    src, tgt = src[order], tgt[order]
    starts = torch.zeros(num_nodes + 1, dtype=torch.int64, device=src.device)
    starts[1:] = torch.cumsum(torch.bincount(tgt, minlength=num_nodes), 0)
    return GatLevel(n=n, num_nodes=num_nodes, src=src, tgt=tgt, starts=starts)


def attention_edges(level: ref_level.Level) -> GatLevel:
    """The shared level's graph (``reference/level.py``) for attention."""
    return from_edges(level.graph.src, level.graph.tgt, level.num_nodes, level.n)


def init_params(seed: int, specs: Sequence[Layer], device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def glorot(shape):
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * limit

    out = []
    for s in specs:
        hf = s.heads * s.width
        lp = {"w": glorot((s.in_dim, hf)), "att_src": glorot((s.heads, s.width)),
              "att_dst": glorot((s.heads, s.width)),
              "b": torch.zeros(hf if s.concat else s.width, device=device)}
        if s.residual:
            lp["res_w"] = glorot((s.in_dim, hf))
            lp["res_b"] = torch.zeros(hf, device=device)
        out.append(lp)
    return {"layers": out}


def _block_attention(z: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                     src: torch.Tensor, tgt: torch.Tensor, rows: int) -> torch.Tensor:
    """The attention of one block of ``rows`` targets (``tgt`` counted from
    the block's first row): [rows, H, F]."""
    h = a_src.shape[1]
    e = F.leaky_relu(a_src[src] + a_dst[tgt], NEG_SLOPE)  # [E_b, H]
    top = torch.full((rows, h), -torch.inf, dtype=e.dtype, device=e.device)
    # The segment max shifts the exponents only (PyG's softmax detaches it).
    top = top.scatter_reduce(0, tgt[:, None].expand(-1, h), e.detach(), "amax",
                             include_self=True)
    p = torch.exp(e - top[tgt])
    total = torch.zeros((rows, h), dtype=e.dtype, device=e.device).index_add_(0, tgt, p)
    alpha = p / total[tgt]
    msgs = z[src] * alpha[:, :, None]  # [E_b, H, F]
    return torch.zeros((rows,) + tuple(z.shape[1:]), dtype=z.dtype,
                       device=z.device).index_add_(0, tgt, msgs)


def attention(z: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, lv: GatLevel,
              block_elements: int = EDGE_BLOCK_ELEMENTS) -> torch.Tensor:
    """[N, H, F]: every target's attention-weighted sum of its in-edges'
    ``z``, by blocks of targets, each under ``checkpoint``."""
    n = lv.num_nodes
    per_edge = z.shape[1] * z.shape[2]
    starts = lv.starts.cpu().numpy()
    budget = max(1, block_elements // per_edge)
    outs, r0 = [], 0
    while r0 < n:
        # The most rows whose edges fit the budget (at least one row).
        r1 = int(np.searchsorted(starts, starts[r0] + budget, side="right")) - 1
        r1 = min(max(r1, r0 + 1), n)
        e0, e1 = int(starts[r0]), int(starts[r1])
        src, tgt = lv.src[e0:e1], lv.tgt[e0:e1] - r0
        outs.append(checkpoint(_block_attention, z, a_src, a_dst[r0:r1], src, tgt, r1 - r0,
                               use_reentrant=False))
        r0 = r1
    return torch.cat(outs)


def forward(params: dict, specs: Sequence[Layer], lv: GatLevel, x: torch.Tensor,
            block_elements: int = EDGE_BLOCK_ELEMENTS) -> torch.Tensor:
    """Log-softmax of the class logits [N, C]."""
    h = x
    for i, (lp, s) in enumerate(zip(params["layers"], specs)):
        n = h.shape[0]
        z = (h @ lp["w"]).reshape(n, s.heads, s.width)
        a_src = (z * lp["att_src"]).sum(-1)
        a_dst = (z * lp["att_dst"]).sum(-1)
        out = attention(z, a_src, a_dst, lv, block_elements)
        out = out.reshape(n, s.heads * s.width) if s.concat else out.mean(1)
        out = out + lp["b"]
        if s.residual:
            out = out + (h @ lp["res_w"] + lp["res_b"])
        h = F.elu(out) if i < len(specs) - 1 else out
    return F.log_softmax(h, dim=-1)


@contextlib.contextmanager
def _tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def train_steps(params: dict, specs: Sequence[Layer], lv: GatLevel, x: torch.Tensor,
                y: torch.Tensor, mask: torch.Tensor, steps: int, lr: float, l2: float,
                weight_decay: float, block_elements: int = EDGE_BLOCK_ELEMENTS
                ) -> Dict[str, object]:
    """``steps`` full-batch Adam steps.  Returns each step's loss (before its
    update), each leaf's first gradient norm and each leaf's change over the
    steps (float64 norms), with the leaves' names in the program's order."""
    leaves = named_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
    start = [p.detach().clone() for _, p in leaves]
    mu = [torch.zeros_like(p) for _, p in leaves]
    nu = [torch.zeros_like(p) for _, p in leaves]
    decay = weight_decay if l2 <= 0 else 0.0
    losses: List[float] = []
    first_grads: Optional[List[float]] = None
    for step in range(1, steps + 1):
        log_sm = forward(params, specs, lv, x, block_elements)
        nll = -torch.gather(log_sm, -1, y[:, None])[:, 0]
        loss = torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
        if l2:
            loss = loss + l2 * sum(torch.sum(p * p) for _, p in leaves)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = [float(torch.linalg.vector_norm(g.double())) for g in grads]
        bc1, bc2 = adam_corrections(step)
        with torch.no_grad():
            for (_, p), g, m, v in zip(leaves, grads, mu, nu):
                if decay:
                    g = g + decay * p
                m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                p.add_((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS), alpha=-lr)
        del grads, log_sm, loss
    changes = [float(torch.linalg.vector_norm((p.detach() - s).double()))
               for (_, p), s in zip(leaves, start)]
    return {"names": [n for n, _ in leaves], "numels": [p.numel() for _, p in leaves],
            "losses": losses, "grad_norms": first_grads, "change_norms": changes}


def first_steps(lv: GatLevel, cfg: dict, x: np.ndarray, y: np.ndarray, num_classes: int,
                seed: int, steps: int, device, tf32: bool = False, half_batch: bool = False,
                block_elements: int = EDGE_BLOCK_ELEMENTS) -> Dict[str, object]:
    """``steps`` full-batch steps of the configured GAT on ``lv`` from
    ``seed``.  ``tf32``: the matrix products in TF32 (the control);
    ``half_batch``: the loss's mean over every other node only (a planted
    fault)."""
    gcn = cfg["gcn"]
    specs = layers(x.shape[1], gcn["hidden_layer_dims"], gcn["gat_heads"], num_classes)
    n = lv.num_nodes
    xs = torch.from_numpy(x).to(device)
    ys = torch.from_numpy(y).to(device)
    mask = torch.ones(n, device=device)
    if half_batch:
        mask[1::2] = 0.0
    params = init_params(seed + lv.n, specs, device)
    with _tf32(tf32):
        return train_steps(params, specs, lv, xs, ys, mask, steps, gcn["lr"],
                           gcn["l2_reg_lambda"], gcn.get("weight_decay", 0.0), block_elements)
