"""Plain PyTorch DirectGCN level trained full batch with Adam: the
benchmark's reference, written from the published model and independent of
the program under test.

Model (ProtGram-DirectGCN, src/models/protgram_directgcn.py:20-222): per
layer three paths over the in, out and undirected operators, each
``P (h @ (W_path + W_shared)) + b_path + b_shared``; gated per node
``c_all * (c_und * und + c_dir * (c_in * in + c_out * out)) + constant``;
a residual (a linear projection where the width changes); leaky ReLU 0.01;
inverted dropout.  A two-layer decoder (``relu``, dropout, linear) gives the
class logits, and the loss is the masked mean negative log-likelihood plus
``l2`` times the sum of squares of every parameter.  Adam (b1 0.9, b2 0.999,
eps 1e-8) with its bias corrections computed in float32.

Drawing: the initial parameters and the dropout masks are drawn as the
configuration's seed prescribes: uniform draws ``(rand * 2 - 1) * limit``
from one ``torch.Generator`` on the device in a fixed order (xavier limits
for the path weights and the constant, ``sqrt(1/fan_in)`` for linear
layers); per forward pass one seed a layer and one for the decoder drawn
with ``randint(0, 2**62)`` from a host generator; each mask ``rand < keep``
from a device generator seeded with its seed, over the layer's whole
node-space tensor.  Node tables span the configured node space, so a
padded layout's rows take part as the configuration's do.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

GATES = ("c_in", "c_out", "c_directed", "c_undirected", "c_all")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LEAKY_SLOPE = 0.01


class SparseOperator:
    """``out = S @ x`` with ``S[tgt, src] = w`` on the node space, and its
    transpose for the backward pass."""

    def __init__(self, entries, positions: torch.Tensor, n_space: int):
        src, tgt, vals = entries
        rows, cols = positions[tgt], positions[src]
        with warnings.catch_warnings():  # sparse CSR's "beta" notices
            warnings.simplefilter("ignore", UserWarning)
            self.s = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n_space, n_space),
                                             check_invariants=False).coalesce().to_sparse_csr()
            self.st = torch.sparse_coo_tensor(torch.stack([cols, rows]), vals,
                                              (n_space, n_space),
                                              check_invariants=False).coalesce().to_sparse_csr()
        self.nnz = int(len(vals))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Product.apply(x, self)


class _Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return torch.sparse.mm(op.s, x)

    @staticmethod
    def backward(ctx, grad):
        return torch.sparse.mm(ctx.op.st, grad.contiguous()), None


def init_params(seed: int, dims: Sequence[int], n_space: int, num_classes: int,
                device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def uniform(shape, limit):
        return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * limit

    def linear(fi, fo):
        limit = math.sqrt(1.0 / fi)
        return uniform((fi, fo), limit), uniform((fo,), limit)

    layers, res = [], []
    for fi, fo in zip(dims[:-1], dims[1:]):
        p = {name: uniform((fi, fo), math.sqrt(6.0 / (fi + fo)))
             for name in ("w_main_in", "w_main_out", "w_und", "w_shared")}
        for name in ("b_main_in", "b_main_out", "b_und", "b_shared_in", "b_shared_out",
                     "b_shared_und"):
            p[name] = torch.zeros(fo, device=device)
        for name in GATES:
            p[name] = torch.ones((n_space, 1), device=device)
        p["constant"] = uniform((n_space, fo), math.sqrt(6.0 / (fo + n_space)))
        layers.append(p)
        if fi != fo:
            w, b = linear(fi, fo)
            res.append({"w": w, "b": b})
        else:
            res.append(None)
    hidden = max(dims[-1] // 2 if dims[-1] > 1 else 1, 1)
    w1, b1 = linear(dims[-1], hidden)
    w2, b2 = linear(hidden, num_classes)
    return {"layers": layers, "res_projs": res,
            "decoder": {"w1": w1, "b1": b1, "w2": w2, "b2": b2}}


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor, dict keys in sorted order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    out: List[Tuple[str, torch.Tensor]] = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += named_leaves(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += named_leaves(v, f"{prefix}.{i}")
    return out


def dropout_seeds(gen: torch.Generator, count: int) -> List[int]:
    return torch.randint(0, 2**62, (count,), generator=gen).tolist()


def dropout(t: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    keep = 1.0 - rate
    gen = torch.Generator(device=t.device).manual_seed(seed)
    mask = torch.rand(t.shape, generator=gen, device=t.device) < keep
    return torch.where(mask, t / keep, torch.zeros((), dtype=t.dtype, device=t.device))


def forward(params: dict, ops: Sequence[SparseOperator], x: torch.Tensor,
            seeds: Sequence[int], rate: float, decoder_rate: float) -> torch.Tensor:
    """Log-softmax of the class logits over the node space (training mode)."""
    p_in, p_out, p_und = ops
    h = x
    for i, (lp, rp) in enumerate(zip(params["layers"], params["res_projs"])):
        ic = p_in(h @ (lp["w_main_in"] + lp["w_shared"])) + (lp["b_main_in"] + lp["b_shared_in"])
        oc = p_out(h @ (lp["w_main_out"] + lp["w_shared"])) + (lp["b_main_out"]
                                                              + lp["b_shared_out"])
        uc = p_und(h @ (lp["w_und"] + lp["w_shared"])) + (lp["b_und"] + lp["b_shared_und"])
        directed = lp["c_directed"] * (lp["c_in"] * ic + lp["c_out"] * oc)
        gcn = lp["c_all"] * (lp["c_undirected"] * uc + directed) + lp["constant"]
        res = h @ rp["w"] + rp["b"] if rp is not None else h
        h = F.leaky_relu(gcn + res, negative_slope=LEAKY_SLOPE)
        if rate > 0:
            h = dropout(h, rate, seeds[i])
    dec = params["decoder"]
    z = F.relu(h @ dec["w1"] + dec["b1"])
    if decoder_rate > 0:
        z = dropout(z, decoder_rate, seeds[-1])
    return F.log_softmax(z @ dec["w2"] + dec["b2"], dim=-1)


def loss_fn(params: dict, log_sm: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
            l2: float) -> torch.Tensor:
    nll = -torch.gather(log_sm, -1, y[:, None])[:, 0]
    primary = torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    return primary + l2 * sum(torch.sum(p * p) for _, p in named_leaves(params))


def adam_corrections(step: int) -> Tuple[float, float]:
    t = np.float32(step)
    return (float(np.float32(1) - np.float32(ADAM_B1) ** t),
            float(np.float32(1) - np.float32(ADAM_B2) ** t))


def train_steps(params: dict, ops, x, y, mask, steps: int, lr: float, l2: float,
                rate: float, decoder_rate: float, seed_gen: torch.Generator
                ) -> Dict[str, object]:
    """``steps`` full-batch Adam steps.  Returns each step's loss (before
    its update), each leaf's first gradient norm and each leaf's change
    over the steps (float64 norms), with the leaves' names."""
    leaves = named_leaves(params)
    for _, p in leaves:
        p.requires_grad_(True)
    start = [p.detach().clone() for _, p in leaves]
    mu = [torch.zeros_like(p) for _, p in leaves]
    nu = [torch.zeros_like(p) for _, p in leaves]
    losses: List[float] = []
    first_grads: Optional[List[float]] = None
    for step in range(1, steps + 1):
        seeds = dropout_seeds(seed_gen, len(params["layers"]) + 1)
        log_sm = forward(params, ops, x, seeds, rate, decoder_rate)
        loss = loss_fn(params, log_sm, y, mask, l2)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = [float(torch.linalg.vector_norm(g.double())) for g in grads]
        bc1, bc2 = adam_corrections(step)
        with torch.no_grad():
            for (_, p), g, m, v in zip(leaves, grads, mu, nu):
                m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                p.add_((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS), alpha=-lr)
        del grads, log_sm, loss
    changes = [float(torch.linalg.vector_norm((p.detach() - s).double()))
               for (_, p), s in zip(leaves, start)]
    return {"names": [n for n, _ in leaves], "numels": [p.numel() for _, p in leaves],
            "losses": losses, "grad_norms": first_grads, "change_norms": changes}
