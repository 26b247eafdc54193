"""Hierarchical DirectGCN trainer: per-n-gram-level training with feature
cascading and protein pooling.

Port of protgram_directgcn_tpu/pipeline/trainer.py:54-230, 256-278,
1271-1374, 1396-1634, 1691-2204 (reference:
src/pipeline/protgram_directgcn_trainer.py:68-426) for single-device
training, full batch or on Cluster-GCN batches.  Each level's plan
(``_level_plan``) picks the first memory tier that fits the device, with the
JAX package's ladder:

0. float32 compute and node parameters, no remat, Adam;
1. tier 0 + remat (each layer recomputed in the backward pass);
2. bfloat16 compute and node parameters + remat;
3. tier 2 + factored Adafactor moments for the node tables + per-path remat
   (the packed sub-128 carry of the retile kernels on hypercube levels);
4. tier 3 + the layer-staged step (``make_train_step_staged``): one layer's
   backward and update at a time.

Where no tier fits, ``gcn.oversize_policy`` decides: "degrade" halves the
hidden dims until tier 4 fits and trains the level at them, "error" raises.

All optimizer state is float32.  Under ``gcn.spmm_mode="auto"`` levels
n >= 2 whose character hypercube is at most 4x the vocabulary train on the
K1/K2 hypercube operators, and the others on the format
``spmm.build_adjacency`` picks (the n = 1 level: dense), built in the plan's
compute type.  ``spmm_mode="pallas"`` trains every level on ELL operators
through the CUDA ELL kernels.

A level above ``gcn.cluster_training_threshold_nodes`` trains on Cluster-GCN
batches (``_make_cluster_batches``: BFS parts, dense or padded-ELL blocks)
under ``gcn.use_cluster_training``, unless its operators are the hypercube
and ``gcn.cluster_auto_fullbatch`` holds; its embeddings come from the eval
pass on the full level.  ``run`` logs each level's parameters and, on a
full-batch level, its loss and learning rate every epoch
(``utils/metrics.py``, ``level_checkpoints/run_n{n}``), saves the training
state every ``gcn.checkpoint_every_epochs`` epochs and resumes from the
latest (``utils/checkpoint.py``, ``level_checkpoints/train_state_n{n}``),
and writes the pooled embeddings (H5 where h5py imports, else ``.npz``)
and, under ``gcn.apply_pca``, their PCA; under ``gcn.run_sanity_check_ppi``
it then runs the PPI sanity check on the last file written
(``pipeline/ppi.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.graph.partition import partition_nodes
from protgram_directgcn_torch.graph.structure import DeviceGraph, NgramGraph, load_graph
from protgram_directgcn_torch.models.directgcn import (
    DirectGCNConfig,
    apply_decoder,
    apply_layer_range,
    directgcn_apply,
    dropout_seeds,
    init_directgcn_params,
    named_leaves,
    param_leaves,
    unpack_rg_carry,
)
from protgram_directgcn_torch.models.mlp import OptaxAdam, adam_bias_corrections
from protgram_directgcn_torch.ops import ell_kernels, hyper_kernels, retile
from protgram_directgcn_torch.ops.hypercube import BlockStructureError, vocab_char_codes
from protgram_directgcn_torch.ops.spmm import DenseAdj, EllAdj, _ell_one_sided
from protgram_directgcn_torch.parallel import distributed as comm
from protgram_directgcn_torch.parallel import mesh
from protgram_directgcn_torch.pipeline.labels import generate_labels
from protgram_directgcn_torch.pipeline.ppi import run_sanity_check_ppi
from protgram_directgcn_torch.utils import checkpoint as ckpt
from protgram_directgcn_torch.utils import embeddings as emb_utils
from protgram_directgcn_torch.utils.device import resolve_device
from protgram_directgcn_torch.utils.io import (
    ensure_dir,
    generate_regex_id_map,
    logger,
    parse_fasta,
    write_embeddings,
)
from protgram_directgcn_torch.utils.metrics import MetricLogger


class PlateauScheduler:
    """ReduceLROnPlateau with torch defaults (mode=min, rel threshold 1e-4)
    (reference: protgram_directgcn_trainer.py:84)."""

    def __init__(self, lr: float, patience: int, factor: float, threshold: float = 1e-4):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, loss: float) -> float:
        if loss < self.best * (1.0 - self.threshold):
            self.best = loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr


class EarlyStopper:
    """Stop when loss stops improving (reference: protgram_directgcn_trainer.py:48-65)."""

    def __init__(self, patience: int, min_delta: float):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss = float("inf")

    def should_stop(self, loss: float) -> bool:
        if loss < self.best_loss - self.min_delta:
            self.best_loss = loss
            self.counter = 0
            return False
        self.counter += 1
        return self.counter >= self.patience


# The per-node tables (trainer.py:101-103), selected by name, and the size
# both of a moment's two largest dims must reach for Adafactor to factor it
# (trainer.py:107).
_NODE_PARAM_NAMES = frozenset(
    {"c_in", "c_out", "c_directed", "c_undirected", "c_all", "constant"}
)
_FACTOR_MIN_DIM = 32
_ADAM_B1, _ADAM_B2, _ADAM_EPS = OptaxAdam.B1, OptaxAdam.B2, OptaxAdam.EPS
_ADAFACTOR_DECAY, _ADAFACTOR_EPS = 0.999, 1e-30


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the second-largest and the largest dim,
    or None unless both reach ``_FACTOR_MIN_DIM``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _FACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


# An update runs over slices of a parameter's first dim of at most this many
# elements, so that its f32 temporaries stay at a few hundred MB where a
# 5-gram constant holds 10^9 elements (XLA fuses the same update in place).
_UPDATE_CHUNK = 1 << 25


class TrainOptimizer(torch.optim.Optimizer):
    """The JAX package's ``make_optimizer`` (trainer.py:111-197).

    - Weight decay is added to the gradient before the moments (optax
      ``add_decayed_weights``; torch.optim.Adam's L2), summed in f32 and
      rounded to the parameter's type, the type of its gradient.
    - Group "adam": Adam (b1 0.9, b2 0.999, eps 1e-8), its bias corrections
      in float32 as optax computes them (``adam_bias_corrections``).
    - Group "adafactor" (the node tables when factored): optax 0.2.6's
      ``adafactor`` with ``multiply_by_parameter_scale=False``,
      ``clipping_threshold=None``, ``decay_rate=0.999``,
      ``min_dim_size_to_factor=32``, ``eps=1e-30`` and no momentum: the
      second moment decays by 1 - (t+1)^-0.999 at step t, and is factored
      over the two largest dims where both reach 32 (row and column means
      of the squared gradient), else kept whole.
    - Every moment is float32 whatever the parameter's type (``_f32_state``:
      a bf16 moment stops moving once 1e-3 increments fall below bf16's
      resolution); the f32 update is added to the parameter in f32 and the
      sum stored in the parameter's type (``optax.apply_updates``).

    A parameter without a gradient is skipped, as torch.optim does.  The
    float32 Adam leaves of at most ``_UPDATE_CHUNK`` elements update
    together, one ``torch._foreach_*`` launch per operation for all of them
    (torch.optim.Adam's multi-tensor path); every other leaf updates on its
    own, slice by slice.  On a node shard (``parallel/``) the Adafactor
    group's leaves hold this rank's rows of ``n_global`` nodes: their
    factoring follows the global shape and their means over the node axis
    are summed over the ranks.
    """

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, wd = group["lr"], group["weight_decay"]
            params = [p for p in group["params"] if p.grad is not None]
            if group["kind"] == "adafactor":
                for p in params:
                    _adafactor_update(self.state[p], p, lr, wd, group.get("n_global"))
                continue
            together: Dict[int, list] = {}
            for p in params:
                if p.dtype == torch.float32 and p.numel() <= _UPDATE_CHUNK:
                    step = _adam_begin(self.state[p], p)
                    together.setdefault(step, []).append(p)
                else:
                    _adam_update(self.state[p], p, lr, wd)
            for step, ps in together.items():
                _adam_foreach([self.state[p] for p in ps], ps, step, lr, wd)


def _slices(t: torch.Tensor):
    rows = max(1, _UPDATE_CHUNK // max(1, t[0].numel()))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def _grad_f32(p: torch.Tensor, sl: slice, wd: float) -> torch.Tensor:
    g = p.grad[sl].float()
    if wd:
        g = (g + wd * p[sl].float()).to(p.dtype).float()
    return g


def _apply(p: torch.Tensor, sl: slice, lr: float, direction: torch.Tensor) -> None:
    p[sl] = (p[sl].float() - lr * direction).to(p.dtype)


def _adam_begin(state: dict, p: torch.Tensor) -> int:
    """Create a leaf's f32 moments at its first update; count the step."""
    if not state:
        state.update(step=0, mu=torch.zeros_like(p, dtype=torch.float32),
                     nu=torch.zeros_like(p, dtype=torch.float32))
    state["step"] += 1
    return state["step"]


def _adam_foreach(states: list, ps: list, step: int, lr: float, wd: float) -> None:
    """``_adam_update`` for float32 leaves at one step count, together."""
    bc1, bc2 = adam_bias_corrections(step)
    grads = [p.grad for p in ps]
    if wd:
        grads = torch._foreach_add(grads, ps, alpha=wd)
    mus, nus = [st["mu"] for st in states], [st["nu"] for st in states]
    torch._foreach_mul_(mus, _ADAM_B1)
    torch._foreach_add_(mus, grads, alpha=1.0 - _ADAM_B1)
    torch._foreach_mul_(nus, _ADAM_B2)
    torch._foreach_addcmul_(nus, grads, grads, value=1.0 - _ADAM_B2)
    denom = torch._foreach_div(nus, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, _ADAM_EPS)
    direction = torch._foreach_div(mus, bc1)
    torch._foreach_div_(direction, denom)
    torch._foreach_add_(ps, direction, alpha=-lr)


def _adam_update(state: dict, p: torch.Tensor, lr: float, wd: float) -> None:
    """optax ``scale_by_adam``: bias-corrected mu / (sqrt(nu) + eps), with
    optax's float32 corrections."""
    step = _adam_begin(state, p)
    bc1, bc2 = adam_bias_corrections(step)
    for sl in _slices(p):
        g = _grad_f32(p, sl, wd)
        mu = state["mu"][sl].mul_(_ADAM_B1).add_(g, alpha=1.0 - _ADAM_B1)
        nu = state["nu"][sl].mul_(_ADAM_B2).addcmul_(g, g, value=1.0 - _ADAM_B2)
        _apply(p, sl, lr, (mu / bc1) / (torch.sqrt(nu / bc2) + _ADAM_EPS))


def _adafactor_update(state: dict, p: torch.Tensor, lr: float, wd: float,
                      n_global: Optional[int] = None) -> None:
    """optax ``scale_by_factored_rms`` (factorized.py:143-182).  A factored
    moment takes two passes over the slices: the squared gradient's sums
    (accumulated over the slices where dim 0 is reduced), then the update.
    ``n_global``: ``p`` holds this rank's rows of that many nodes (dim 0);
    the factoring is the global shape's and a sum over dim 0 runs over
    every rank."""
    shape = tuple(p.shape)
    shape_g = shape if n_global is None else (int(n_global),) + shape[1:]
    dims = _factored_dims(shape_g)

    def drop(d):
        return shape[:d] + shape[d + 1:]

    if not state:
        state["step"] = 0
        if dims is None:
            state["v"] = torch.zeros_like(p, dtype=torch.float32)
        else:
            d1, d0 = dims
            state["v_row"] = p.new_zeros(drop(d0), dtype=torch.float32)
            state["v_col"] = p.new_zeros(drop(d1), dtype=torch.float32)
    t = np.float32(state["step"] + 1)
    beta = float(np.float32(1.0) - t ** np.float32(-_ADAFACTOR_DECAY))
    state["step"] += 1
    if dims is None:
        for sl in _slices(p):
            g = _grad_f32(p, sl, wd)
            v = state["v"][sl].mul_(beta).add_(g * g + _ADAFACTOR_EPS, alpha=1.0 - beta)
            _apply(p, sl, lr, g * v.pow(-0.5))
        return
    d1, d0 = dims
    sums = {d: p.new_zeros(drop(d), dtype=torch.float32) for d in (d0, d1)}
    for sl in _slices(p):
        g = _grad_f32(p, sl, wd)
        sq = g * g + _ADAFACTOR_EPS
        for d, total in sums.items():
            if d == 0:
                total += sq.sum(0)
            else:
                total[sl] = sq.sum(d)
    if n_global is not None and 0 in sums:
        comm.all_reduce_sum(sums[0])
    v_row = state["v_row"].mul_(beta).add_(sums[d0] / shape_g[d0], alpha=1.0 - beta)
    v_col = state["v_col"].mul_(beta).add_(sums[d1] / shape_g[d1], alpha=1.0 - beta)
    reduced_d1 = d1 - 1 if d1 > d0 else d1
    if n_global is not None and d0 != 0 and reduced_d1 == 0:  # a mean over the nodes
        row_mean = comm.all_reduce_sum(v_row.sum(0, keepdim=True)) / shape_g[0]
    else:
        row_mean = v_row.mean(reduced_d1, keepdim=True)
    row_factor = (v_row / row_mean).pow(-0.5).unsqueeze(d0)
    col_factor = v_col.pow(-0.5).unsqueeze(d1)
    for sl in _slices(p):
        g = _grad_f32(p, sl, wd)
        _apply(p, sl, lr, g * (row_factor if d0 == 0 else row_factor[sl])
               * (col_factor if d1 == 0 else col_factor[sl]))


def make_optimizer(params, lr: float, weight_decay: float,
                   factor_node_params_above: Optional[int] = None,
                   n_global: Optional[int] = None) -> TrainOptimizer:
    """Adam over every parameter (reference: protgram_directgcn_trainer.py:354);
    with ``factor_node_params_above=N``, the per-node tables (by name, with
    shape[0] == N, or an rg constant [A, G, out] with A*G == N) train with
    factored Adafactor instead (trainer.py:134-197).  On a node shard, N is
    the rank's rows and ``n_global`` the level's nodes."""
    n = factor_node_params_above

    def is_node(name: str, p: torch.Tensor) -> bool:
        return n is not None and name in _NODE_PARAM_NAMES and p.dim() >= 1 and (
            p.shape[0] == n or (p.dim() == 3 and p.shape[0] * p.shape[1] == n))

    leaves = named_leaves(params)
    groups = [{"params": [p for name, p in leaves if not is_node(name, p)], "kind": "adam"},
              {"params": [p for name, p in leaves if is_node(name, p)], "kind": "adafactor",
               "n_global": n_global}]
    return TrainOptimizer([grp for grp in groups if grp["params"]],
                          {"lr": lr, "weight_decay": weight_decay})


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def _loss_fn(params, graph, x, y, mask, weight_factor, gen, model_cfg, l2_lambda,
             original_indices=None):
    """Masked next-node NLL plus ``l2_lambda`` times the sum of squares of
    every parameter (in f32); returns (loss, primary).  ``original_indices``:
    a Cluster-GCN batch's node ids (the model gathers its per-node
    parameters there)."""
    log_sm, _ = directgcn_apply(params, graph, x, model_cfg, train=True, gen=gen,
                                original_indices=original_indices, flatten_rg=False)
    primary = _masked_nll(log_sm, y, mask)
    l2 = sum(torch.sum(torch.square(p.float())) for p in param_leaves(params))
    return primary * weight_factor + l2_lambda * l2, primary


def _masked_nll(log_sm: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean negative log-likelihood of the labels over the masked nodes;
    an rg output ``[A, G, C]`` views the label and mask vectors ``[A, G]``."""
    if log_sm.dim() == 3:
        y = y.reshape(log_sm.shape[:2])
        mask = mask.reshape(log_sm.shape[:2])
    per_node = -torch.gather(log_sm, -1, y[..., None])[..., 0]
    return torch.sum(per_node * mask) / torch.clamp(mask.sum(), min=1.0)


def make_train_step(model_cfg: DirectGCNConfig, opt: torch.optim.Optimizer, l2_lambda: float):
    """One step on the full level or a Cluster-GCN batch: loss and
    gradients, then the optimizer update.  Returns (loss, primary) as
    computed before the update."""

    def step(params, graph, x, y, mask, weight_factor, gen, original_indices=None):
        opt.zero_grad(set_to_none=True)
        loss, primary = _loss_fn(params, graph, x, y, mask, weight_factor, gen, model_cfg,
                                 l2_lambda, original_indices)
        loss.backward()
        opt.step()
        return loss.detach(), primary.detach()

    return step


@dataclasses.dataclass
class NodeShard:
    """This rank's node rows on a node-sharded level (``parallel/``): the
    rank's operator ``adj`` (``HaloAdj`` or ``HyperShardAdj``) names them
    (``adj.node_rows()``), ``n_global`` is the padded node space."""

    adj: Any
    n_global: int

    @property
    def n_local(self) -> int:
        return int(self.adj.n_out)

    @property
    def is_main(self) -> bool:
        return comm.is_main()

    def is_node(self, name: str, p: torch.Tensor) -> bool:
        return mesh.node_sharded(name, p, self.n_local)

    def state_is_node(self, key: str, p: torch.Tensor) -> bool:
        """Whether optimizer state ``key`` of node leaf ``p`` holds node rows:
        Adam's moments and an unfactored Adafactor moment do; of a factored
        one, the factor that kept dim 0."""
        if key in ("mu", "nu", "v"):
            return True
        dims = _factored_dims((self.n_global,) + tuple(p.shape[1:]))
        if dims is None or key not in ("v_row", "v_col"):
            return False
        d1, d0 = dims
        return (d0 if key == "v_row" else d1) != 0

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t`` at their global ids."""
        return mesh.gather_rows(t, self.adj, self.n_global)

    def slab(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global ``t``."""
        return t[self.adj.node_rows().to(t.device)].contiguous()


def make_train_step_sharded(model_cfg: DirectGCNConfig, opt: torch.optim.Optimizer,
                            l2_lambda: float, shard: NodeShard, mask_total: float):
    """One full-batch step on a node shard, the JAX package's GSPMD step
    written out by hand.  Each rank's loss is its nodes' share of the global
    masked mean (``mask_total``: the mask summed over the ranks) plus
    ``l2_lambda`` times its node rows' squares and 1 / world of the
    replicated leaves' squares, so that the ranks' losses sum to the global
    loss; the replicated leaves' gradients are summed over the ranks before
    the update (node rows get theirs whole through the exchanges' backward).
    Returns (loss, primary) summed over the ranks, as computed before the
    update."""
    world = comm.world_size()

    def step(params, graph, x, y, mask, weight_factor, gen, original_indices=None):
        if original_indices is not None:
            raise ValueError("a node-sharded step trains the full level")
        opt.zero_grad(set_to_none=True)
        log_sm, _ = directgcn_apply(params, graph, x, model_cfg, train=True, gen=gen,
                                    flatten_rg=False)
        if log_sm.dim() == 3:
            y = y.reshape(log_sm.shape[:2])
            mask = mask.reshape(log_sm.shape[:2])
        per_node = -torch.gather(log_sm, -1, y[..., None])[..., 0]
        primary = torch.sum(per_node * mask) / max(mask_total, 1.0)
        leaves = named_leaves(params)
        l2 = sum(torch.sum(torch.square(p.float())) * (1.0 if shard.is_node(n, p) else 1.0 / world)
                 for n, p in leaves)
        loss = primary * weight_factor + l2_lambda * l2
        loss.backward()
        # The leaves without a gradient are the same on every rank.
        replicated = [p for n, p in leaves if not shard.is_node(n, p) and p.grad is not None]
        flat = comm.all_reduce_sum(torch.cat([p.grad.reshape(-1).float() for p in replicated]))
        offset = 0
        for p in replicated:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
            offset += p.numel()
        opt.step()
        both = comm.all_reduce_sum(torch.stack([loss.detach().float(), primary.detach().float()]))
        return both[0], both[1]

    return step


def _l2_sum(leaves) -> torch.Tensor:
    """Sum of squares of the leaves in f32, slice by slice (bounded f32
    temporaries where a node table holds 10^9 elements)."""
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    with torch.no_grad():
        for p in leaves:
            for sl in _slices(p):
                total += torch.sum(torch.square(p[sl].float()))
    return total


def _add_l2_grads(leaves, l2_lambda: float) -> None:
    """The gradient of ``l2_lambda * sum(p.float() ** 2)`` added to each
    leaf's gradient in f32 and rounded to the gradient's type, as the JAX
    staged step adds it (trainer.py:350-357)."""
    if not l2_lambda:
        return
    with torch.no_grad():
        for p in leaves:
            for sl in _slices(p):
                p.grad[sl] = (p.grad[sl].float() + 2.0 * l2_lambda * p[sl].float()).to(p.grad.dtype)


def _packable(width: int) -> bool:
    """Whether a carry of this width packs below 128 lanes (pack_rg_carry)."""
    return width < 128 and 128 % width == 0


def make_train_step_staged(model_cfg: DirectGCNConfig, opt: torch.optim.Optimizer,
                           l2_lambda: float):
    """Memory tier 4: the fused step's update, one layer at a time
    (make_train_step_staged, trainer.py:279-1265 of the JAX package).

    - The layers run forward without autograd, one stage a layer.  A
      stage's input carry is kept where it is x, the decoder's input, or a
      width that packs below 128 lanes (JAX ``held``, trainer.py:1022-1034);
      another one is recomputed from the nearest kept carry below it when
      its layer's backward needs it.
    - The decoder and the loss run with autograd; the decoder's parameters
      are updated at once and the carry's cotangent kept.
    - From the last layer down: the layer is recomputed from its input
      carry with autograd (layer and per-path remat, the packed carry, as
      the plan sets them), the cotangent is backpropagated, the layer's
      parameters are updated and their gradients freed before the next
      layer down.

    The update equals the fused step's: every gradient is taken at the
    step's starting parameters (a layer's recompute reads only layers below
    it, not updated yet), L2 is added to the gradient (``_add_l2_grads``),
    Adam and Adafactor update each leaf on its own with its own step count,
    and the dropout masks come from the same per-layer seeds.  No
    positional-encoding table (n = 1 levels train fused).  Returns (loss,
    primary) as computed before the update."""
    if model_cfg.one_gram_dim:
        raise ValueError("the staged step takes no positional-encoding table (n >= 2 levels)")
    dims = model_cfg.layer_dims
    n_layers = len(dims) - 1
    # held[k]: carry k (layer k's input; k = n_layers: the decoder's) is kept.
    held = [True] + [_packable(dims[k]) for k in range(1, n_layers)] + [True]

    def update(leaves) -> None:
        _add_l2_grads(leaves, l2_lambda)
        opt.step()  # only the leaves with a gradient move
        for p in leaves:
            p.grad = None

    def step(params, graph, x, y, mask, weight_factor, gen, original_indices=None):
        if original_indices is not None:
            raise ValueError("the staged step trains the full level, not a subgraph batch")
        opt.zero_grad(set_to_none=True)
        rg_lead = tuple(x.shape[:2]) if x.dim() == 3 else None
        seeds = dropout_seeds(gen, n_layers + 1)

        def layer(k, c):
            return apply_layer_range(params, graph, c, model_cfg, k, k + 1, train=True,
                                     seeds=seeds, rg_lead=rg_lead)

        carries: List[Optional[torch.Tensor]] = [x] + [None] * n_layers
        with torch.no_grad():
            c = x
            for k in range(n_layers):
                c = layer(k, c)
                if held[k + 1]:
                    carries[k + 1] = c
            del c

        h = carries[n_layers].detach().requires_grad_(True)
        carries[n_layers] = None
        hh = h if rg_lead is None else unpack_rg_carry(h, dims[-1], rg_lead[1])
        logits = apply_decoder(params["decoder"], hh, model_cfg, train=True, seed=seeds[-1])
        log_sm = F.log_softmax(logits.float(), dim=-1).to(logits.dtype)
        primary = _masked_nll(log_sm, y, mask)
        (primary * weight_factor).backward()
        del hh, logits, log_sm
        leaves = param_leaves(params["decoder"])
        l2_sum = _l2_sum(leaves)
        update(leaves)
        g = h.grad
        del h

        for k in reversed(range(n_layers)):
            c = carries[k]
            if c is None:  # recompute from the nearest kept carry below
                j = max(i for i in range(k) if carries[i] is not None)
                with torch.no_grad():
                    c = carries[j]
                    for t in range(j, k):
                        c = layer(t, c)
            c = c.detach().requires_grad_(k > 0)
            layer(k, c).backward(g)
            leaves = param_leaves({"layer": params["layers"][k], "res": params["res_projs"][k]})
            l2_sum = l2_sum + _l2_sum(leaves)
            update(leaves)
            g = c.grad
            if k > 0:
                carries[k] = None
            del c
        loss = primary.detach() * weight_factor + l2_lambda * l2_sum
        return loss, primary.detach()

    return step


def _node_params_to_rg(params, full_graph: DeviceGraph):
    """Store each layer's per-node constant rg ``[A, G, out]`` on hypercube
    levels, as the JAX trainer does (trainer.py:256-278): Adafactor factors
    that shape over (G, out) for each A, so the factored updates follow the
    stored layout.  Gates stay ``[N, 1]``."""
    lead = getattr(full_graph.p_in, "feature_shape", None)
    if lead is None:
        return params
    a, g = lead
    for lp in params["layers"]:
        c = lp.get("constant")
        if c is not None and c.dim() == 2 and c.shape[0] == a * g:
            lp["constant"] = c.reshape(a, g, c.shape[-1])
    return params


# Auto-select the gather-free hypercube format when the padded node space
# [alphabet^n] stays within this multiple of the real vocabulary.
_HYPERCUBE_MAX_RATIO = 4.0


def _launch_counts() -> Dict[str, Dict[str, int]]:
    """Launches so far of every kernel, per direction (K1/K2, ELL, retile)."""
    return {**hyper_kernels.launch_counts(), **ell_kernels.launch_counts(),
            **retile.launch_counts()}


def _launch_diff(before, after) -> Dict[str, Dict[str, int]]:
    return {k: {d: after[k][d] - before[k][d] for d in after[k]} for k in after}


# The "auto" levers of each memory tier (trainer.py:1492-1505): compute
# type, node-table type, remat, factored node moments, per-path remat.
# Tier 4 adds the layer-staged step to tier 3's (``_STAGED_TIER``).
TIER_LEVERS = {
    0: ("float32", "float32", False, False, False),
    1: ("float32", "float32", True, False, False),
    2: ("bfloat16", "bfloat16", True, False, False),
    3: ("bfloat16", "bfloat16", True, True, True),
    4: ("bfloat16", "bfloat16", True, True, True),
}
_STAGED_TIER = 4

# Full-width buffers live at once in a step's backward pass, fitted to the
# peaks ``chip_smoke.py`` measures on an NVIDIA H100 (PERF.md §6): 15 where
# a layer's three paths are recomputed or saved together (the 5-gram level
# at tier 2, the 4-gram level at tier 0), 8 where per-path remat recomputes
# one path at a time (the 5-gram level at tiers 3 and 4; rg levels only).
_WORKSPACE_BUFFERS = 15
_WORKSPACE_BUFFERS_PER_PATH = 8


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """A level's memory-governed knobs (trainer.py:1275-1294), with the
    tier that set them and the residency estimate (bytes) it fitted."""

    tier: int
    compute_dtype: str  # "float32" | "bfloat16"
    node_param_dtype: str
    remat: bool
    remat_paths: bool
    factored: bool  # node tables train with factored Adafactor moments
    bank_budget: int  # device bytes left for the propagation operators
    residency: int
    # > 0: the layer-staged step (tier 4, a stage per layer); the JAX
    # package's split value, (layers + 1) // 2 (trainer.py:1501-1505).
    stage_split: int = 0
    # Set where gcn.oversize_policy="degrade" shrank the hidden dims: the
    # dims the level trains with in place of gcn.hidden_layer_dims.
    layer_dims_override: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass
class ClusterBatch:
    """One padded Cluster-GCN subgraph batch (trainer.py:1297-1321): numpy
    arrays while host-held, tensors once ``to_device`` has copied it.  Every
    batch of a level has the same node budget (and ELL widths)."""

    graph: DeviceGraph  # DenseAdj or EllAdj blocks over the budget's nodes
    x: Any  # [budget, F] f32, zero rows past the cluster
    y: Any  # [budget] int32 (int64 on a device)
    mask: Any  # [budget] f32, 1 on the cluster's nodes
    weight_factor: float  # cluster size / level size
    original_indices: Any  # [budget] int32 node ids in the level's node space (int64 on a device)

    def to_device(self, device) -> "ClusterBatch":
        def dev(a, dtype=None):
            return torch.as_tensor(a).to(device=device, dtype=dtype)

        def adj(m):
            if isinstance(m, DenseAdj):
                return DenseAdj(at=dev(m.at))
            return EllAdj(idx=dev(m.idx), w=dev(m.w), idx_t=dev(m.idx_t), w_t=dev(m.w_t))

        g = self.graph
        return ClusterBatch(
            graph=DeviceGraph(adj(g.p_in), adj(g.p_out), adj(g.p_und), num_nodes=g.num_nodes),
            x=dev(self.x), y=dev(self.y, torch.int64), mask=dev(self.mask),
            weight_factor=self.weight_factor,
            original_indices=dev(self.original_indices, torch.int64))


def _batch_arrays(b: ClusterBatch) -> List[np.ndarray]:
    """A host batch's arrays, in the JAX package's tree order."""
    mats = [b.graph.p_in, b.graph.p_out, b.graph.p_und]
    leaves = [a for m in mats for a in ((m.at,) if isinstance(m, DenseAdj)
                                        else (m.idx, m.w, m.idx_t, m.w_t))]
    return leaves + [b.x, b.y, b.mask, b.original_indices]


class HierarchicalTrainer:
    """Drives n = 1..n_max training and protein pooling
    (reference run() contract: protgram_directgcn_trainer.py:271-426)."""

    # Slack the residency plan leaves free, and the floor the banks get.
    _PLAN_SLACK = 1 << 30
    _MIN_BANK = 2 << 30
    # Budget when the device reports no memory (the CPU).
    _LEVEL_HBM = 14 << 30
    # Test hook: set to an int to pin the device budget.
    _hbm_override: Optional[int] = None

    def __init__(self, config: Optional[Config] = None, device="cuda"):
        self.config = config or Config()
        self.gcn = self.config.gcn
        self.device = resolve_device(device)
        self.id_map: Dict[str, str] = {}
        # Per level: route, plan, losses, epochs, seconds, kernel launches
        # and the device's peak allocation.
        self.level_stats: Dict[int, dict] = {}
        self.pool_seconds = 0.0
        # The final level's pooled {protein_id: vector} of the last run().
        self.pooled: Optional[Dict[str, np.ndarray]] = None
        # The PPI sanity check's metrics of the last run() (None when it was
        # off or skipped) and its pair counts, steps and seconds.
        self.sanity_metrics: Optional[Dict[str, float]] = None
        self.sanity_stats: Dict[str, float] = {}

    # ------------------------------------------------------------------

    def _initial_features(self, graph: NgramGraph, prev_vocab: Optional[np.ndarray],
                          prev_embeds: Optional[np.ndarray], seed: int) -> np.ndarray:
        """Level-1: random [N, d1]; level-n: mean of prefix/suffix (n-1)-gram
        embeddings, zeros if neither exists
        (reference: protgram_directgcn_trainer.py:312-330)."""
        n = graph.num_nodes
        if graph.n == 1 or prev_vocab is None:
            rng = np.random.default_rng(seed)
            return rng.standard_normal((n, self.gcn.one_gram_init_dim)).astype(np.float32)

        dim = prev_embeds.shape[1]
        chars = graph.vocab.view(np.uint32).reshape(n, graph.n)
        prefix = np.ascontiguousarray(chars[:, :-1]).view(f"U{graph.n - 1}").ravel()
        suffix = np.ascontiguousarray(chars[:, 1:]).view(f"U{graph.n - 1}").ravel()

        def lookup(names):
            pos = np.searchsorted(prev_vocab, names)
            pos = np.clip(pos, 0, len(prev_vocab) - 1)
            return np.where(prev_vocab[pos] == names, pos, -1)

        p_idx, s_idx = lookup(prefix), lookup(suffix)
        x = np.zeros((n, dim), dtype=np.float32)
        cnt = (p_idx >= 0).astype(np.float32) + (s_idx >= 0).astype(np.float32)
        x += np.where((p_idx >= 0)[:, None], prev_embeds[np.maximum(p_idx, 0)].astype(np.float32), 0)
        x += np.where((s_idx >= 0)[:, None], prev_embeds[np.maximum(s_idx, 0)].astype(np.float32), 0)
        x /= np.maximum(cnt, 1.0)[:, None]
        return x

    # ------------------------------------------------------------------

    def _device_memory(self) -> int:
        """Bytes one level's training may use: the device's free memory
        (``torch.cuda.mem_get_info``) and the blocks PyTorch's allocator
        holds unused (an earlier level's, freed), less 1 GB."""
        if self._hbm_override is not None:
            return int(self._hbm_override)
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            cached = (torch.cuda.memory_reserved(self.device)
                      - torch.cuda.memory_allocated(self.device))
            return int(free + cached) - (1 << 30)
        return self._LEVEL_HBM

    def _residency(self, n_hyper: int, feat_dim: int, num_classes: int,
                   compute_dtype: str = "float32", node_param_dtype: str = "float32",
                   remat: bool = False, factored: bool = False, remat_paths: bool = False,
                   staged: bool = False, out_dims: Optional[Sequence[int]] = None,
                   shards: int = 1) -> Tuple[int, int, int]:
        """(param_bytes, opt_state_bytes, dynamic_bytes) of one full-batch
        step at ``n_hyper`` nodes, with the levers of the JAX package's
        estimate (trainer.py:1393-1447): per-node tables (5 gates and the
        [N, out] constant per layer) in the node type; their optimizer state
        in f32, two Adam moments or, factored, a full moment for the gates
        and row + column moments for the constants; saved activations (the
        input and, without remat, three paths per layer, with remat one
        carry per layer), node gradients and the full-width buffers of the
        backward pass, all in the compute type.  ``staged`` (tier 4) saves
        only the carries the staged step keeps and holds one layer's node
        gradients (the JAX package halves both; the port's rule fits the
        tier-4 peak measured on the card, PERF.md §6).  ``out_dims`` in
        place of the configured hidden
        dims (the degrade policy sizes smaller ones); ``shards`` divides
        everything: a level trained over that many node shards
        (``parallel.mesh_nodes``).
        The level's operators and input are left to the plan's bank floor
        and slack.

        Where it departs from the JAX estimate: no TPU 128-lane padding, so
        a sub-128 carry counts its logical bytes and the packed carry of
        per-path remat saves nothing; the [N, classes] logits with their
        log-softmax and gradient are counted (JAX leaves them out); and the
        backward pass holds the buffer counts measured on the card (15, or
        8 under per-path remat) where JAX counts 6 under every tier.  Its
        four calibration points, peaks measured on an NVIDIA H100 80GB HBM3
        at 700 W (PERF.md §6): the 4-gram level at tier 0, the 5-gram level
        at tiers 2, 3 and 4; each peak is the estimate plus 0.7-0.9 GB (the
        operators and the input, left to the bank floor)."""
        out_dims = list(self.gcn.hidden_layer_dims if out_dims is None else out_dims)
        node_itm = 2 if node_param_dtype == "bfloat16" else 4
        act_itm = 2 if compute_dtype == "bfloat16" else 4
        n_gates = 5 * len(out_dims) if self.gcn.use_vector_coeffs else 0
        elems_const = n_hyper * sum(out_dims)
        elems_gate = n_hyper * n_gates
        param_b = (elems_const + elems_gate) * node_itm
        if factored:
            opt_b = 4 * elems_gate + 4 * sum(
                (n_hyper + d) if min(n_hyper, d) >= _FACTOR_MIN_DIM else n_hyper * d
                for d in out_dims)
        else:
            opt_b = 2 * 4 * (elems_const + elems_gate)
        per_layer = 1 if remat else 3
        saves = (feat_dim + per_layer * sum(out_dims)) * n_hyper * act_itm
        grads = sum(out_dims) * n_hyper * act_itm
        if staged:
            # The carries the staged step keeps (x, the packable ones, the
            # decoder's input) and one layer's node gradients at a time.
            kept = feat_dim + sum(d for d in out_dims[:-1] if _packable(d)) + out_dims[-1]
            saves = kept * n_hyper * act_itm
            grads = max(out_dims) * n_hyper * act_itm
        buffers = _WORKSPACE_BUFFERS_PER_PATH if remat_paths else _WORKSPACE_BUFFERS
        workspace = buffers * n_hyper * max(out_dims + [feat_dim]) * act_itm
        logits = 3 * n_hyper * num_classes * act_itm
        s = max(1, int(shards))
        return param_b // s, opt_b // s, (saves + grads + workspace + logits) // s

    def _level_plan(self, graph: NgramGraph, feat_dim: int,
                    num_classes: Optional[int] = None) -> LevelPlan:
        """The first memory tier whose residency estimate fits the device
        (trainer.py:1455-1597): tier 0 (f32, Adam), 1 (+ remat), 2 (+ bf16
        compute and node tables), 3 (+ factored node moments and per-path
        remat), 4 (+ the layer-staged step, where the net has two layers or
        more).  The knobs ``gcn.compute_dtype``, ``node_param_dtype``,
        ``remat`` and ``node_param_factored``, where not "auto", override
        their field at every tier.  ``num_classes`` sizes the logits
        (default: one class per node, the next_node task's count).

        Where no tier fits, ``gcn.oversize_policy``: "degrade" halves the
        hidden dims (floor 16) until tier 4 fits, records them in
        ``layer_dims_override`` and takes the first tier that fits them,
        with a warning; "error", or no dims that fit, raises ValueError
        naming the node shards that would fit the configured dims and the
        degraded dims (trainer.py:1535-1576).

        Under ``parallel.mesh_nodes`` every tier is sized per shard, without
        the levers a node-sharded step does not take (per-path remat, the
        staged step; trainer.py:1478-1490)."""
        gcn = self.gcn
        _, alpha = vocab_char_codes(graph.vocab)
        n_hyper = int(alpha) ** graph.n if alpha else graph.num_nodes
        n_nodes = max(n_hyper, graph.num_nodes)
        chip = self._device_memory()
        classes = graph.num_nodes if num_classes is None else num_classes
        n_layers = len(gcn.hidden_layer_dims)
        mesh_nodes = self.config.parallel.mesh_nodes
        level_shards = 1 if mesh_nodes is None else max(1, int(mesh_nodes))

        def resolve(tier: int):
            cd, nd, rm, fc, rp = TIER_LEVERS[tier]
            rp = rp and level_shards == 1
            split = ((n_layers + 1) // 2
                     if tier >= _STAGED_TIER and n_layers >= 2 and level_shards == 1 else 0)
            if gcn.compute_dtype != "auto":
                cd = gcn.compute_dtype
            if gcn.node_param_dtype != "auto":
                nd = gcn.node_param_dtype
            if gcn.remat not in ("auto", None):
                rm = bool(gcn.remat)
            if gcn.node_param_factored in ("on", "off"):
                fc = gcn.node_param_factored == "on"
            return cd, nd, rm, fc, rp, split

        # Per-path remat recomputes one path at a time only on an rg carry
        # (a hypercube level); elsewhere tier 3 keeps a layer's paths live.
        rg = self._takes_hypercube(graph)

        def need(tier: int, dims=None, shards: int = level_shards) -> int:
            cd, nd, rm, fc, rp, split = resolve(tier)
            return sum(self._residency(n_nodes, feat_dim, classes, cd, nd, rm, fc, rp and rg,
                                       staged=split > 0, out_dims=dims, shards=shards))

        def fits(tier: int, dims=None, shards: int = level_shards) -> bool:
            return need(tier, dims, shards) + self._PLAN_SLACK + self._MIN_BANK <= chip

        tiers = range(len(TIER_LEVERS))
        tier = next((t for t in tiers if fits(t)), None)
        dims_override = None
        if tier is None:
            shards = level_shards
            while shards <= 4096 and not fits(_STAGED_TIER, shards=shards):
                shards *= 2
            degraded = list(gcn.hidden_layer_dims)
            while not fits(_STAGED_TIER, degraded) and max(degraded) > 16:
                degraded = [max(16, d // 2) for d in degraded]
            deg_ok = fits(_STAGED_TIER, degraded)
            if gcn.oversize_policy == "error" or not deg_ok:
                dim_fix = (f" or gcn.hidden_layer_dims={degraded} (or smaller)" if deg_ok else
                           " (no hidden-dim reduction fits: the input width or a forced type "
                           "sets the floor)")
                raise ValueError(
                    f"level n={graph.n}: gcn.hidden_layer_dims={list(gcn.hidden_layer_dims)} "
                    f"does not fit {chip / 2**30:.1f} GB at any memory tier ({n_nodes} nodes, "
                    f"tier 4 needs {need(_STAGED_TIER) / 2**30:.1f} GB); set "
                    f"parallel.mesh_nodes>={shards} (node shards, one process a device: "
                    f"torchrun --nproc-per-node {shards}){dim_fix}")
            dims_override = tuple(degraded)
            tier = next(t for t in tiers if fits(t, degraded))
            logger.warning(
                "level n=%d: gcn.hidden_layer_dims=%s does not fit %.1f GB at any memory tier "
                "(%d nodes): DEGRADING to %s (gcn.oversize_policy='degrade'); to train the "
                "configured dims set parallel.mesh_nodes>=%d, or set gcn.hidden_layer_dims",
                graph.n, list(gcn.hidden_layer_dims), chip / 2**30, n_nodes, degraded, shards)
        cd, nd, rm, fc, rp, split = resolve(tier)
        residency = need(tier, dims_override)
        budget = max(self._MIN_BANK, chip - residency - self._PLAN_SLACK)
        if tier > 0:
            logger.info(
                "level n=%d auto-plan tier %d: compute=%s node_params=%s remat=%s "
                "remat_paths=%s factored=%s stage_split=%d (residency %.1f GB of %.1f GB; "
                "banks get %.1f GB)", graph.n, tier, cd, nd, rm, rp, fc, split,
                residency / 2**30, chip / 2**30, budget / 2**30)
        return LevelPlan(tier=tier, compute_dtype=cd, node_param_dtype=nd, remat=rm,
                         remat_paths=rp, factored=fc, bank_budget=int(budget),
                         residency=int(residency), stage_split=split,
                         layer_dims_override=dims_override)

    def _takes_hypercube(self, graph: NgramGraph) -> bool:
        """Whether ``_to_device_graph`` tries the hypercube format for this
        level: n >= 2 under "hypercube", and under "auto" only while
        alpha^n <= 4x the vocabulary."""
        mode = self.gcn.spmm_mode
        if graph.n < 2 or not graph.num_nodes or mode not in ("auto", "hypercube"):
            return False
        if mode == "hypercube":
            return True
        _, alpha = vocab_char_codes(graph.vocab)
        return 0 < alpha**graph.n <= _HYPERCUBE_MAX_RATIO * graph.num_nodes

    def _to_device_graph(self, graph: NgramGraph, plan: LevelPlan,
                         feat_dim: int = 128) -> DeviceGraph:
        """The level's propagation operators (trainer.py:1602-1633), in the
        plan's compute type (the hypercube banks and a dense matrix; the
        edge-list formats keep f32 weights): "pallas" means "ell"; under
        "auto" and "hypercube" the hypercube is tried at n >= 2 ("auto": only
        while alpha^n <= 4x the vocabulary) within ``plan.bank_budget``, and
        where it is not taken or cannot be built (auto only) the format is
        ``graph.to_device(mode="auto", feat_dim=...)``'s choice."""
        mode = self.gcn.spmm_mode if self.gcn.spmm_mode != "pallas" else "ell"
        dtype = torch.bfloat16 if plan.compute_dtype == "bfloat16" else torch.float32
        if self._takes_hypercube(graph):
            try:
                return graph.to_device(mode="hypercube", feat_dim=feat_dim, dtype=dtype,
                                       device=self.device, hbm_budget=plan.bank_budget)
            except BlockStructureError as exc:
                if mode == "hypercube":
                    raise
                logger.info("hypercube format unavailable (%s); falling back", exc)
        return graph.to_device(mode="auto" if mode == "hypercube" else mode, feat_dim=feat_dim,
                               dtype=dtype, device=self.device)

    def _rank_layout(self) -> Optional[mesh.RankLayout]:
        """This process's node shard when the level trains sharded: under
        ``parallel.mesh_nodes`` > 1, or = 1 inside a process group (one
        shard through the sharded operators); else None."""
        par = self.config.parallel
        if par.mesh_nodes is None:
            return None
        par.check()
        if int(par.mesh_nodes) == 1 and not comm.is_initialized():
            return None
        return mesh.make_mesh(int(par.mesh_nodes), int(par.mesh_feats))

    def _to_hyper_shard_graph(self, graph: NgramGraph, layout: mesh.RankLayout,
                              compute_dtype: str = "float32") -> Optional[DeviceGraph]:
        """This rank's operators in the key-sharded hypercube format
        (trainer.py:1635-1690); None where the level's hypercube is sparser
        than ``_HYPERCUBE_MAX_RATIO`` or an edge fits neither key pattern.
        ``parallel.hyper_tri`` "auto" takes the layer-level operator (one
        exchange a relayout for the three matrices) on the card."""
        from protgram_directgcn_torch.graph.transforms import csr_to_coo_arrays
        from protgram_directgcn_torch.parallel import hyper_shard as hs

        codes, alpha = vocab_char_codes(graph.vocab)
        if not 0 < alpha**graph.n <= _HYPERCUBE_MAX_RATIO * max(graph.num_nodes, 1):
            return None
        dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
        shards, rank = layout.node_shards, layout.rank
        try:
            tables = hs.build_hyper_shard_tables(alpha, alpha ** (graph.n - 1), shards)
            ops = [hs.build_hyper_shard(*csr_to_coo_arrays(m), codes, alpha, shards, rank,
                                        self.device, dtype, tables)
                   for m in (graph.mathcal_a_in(), graph.mathcal_a_out(), graph.undirected_norm())]
        except BlockStructureError as exc:
            logger.info("hypercube sharding refused: %s", exc)
            return None
        knob = self.config.parallel.hyper_tri
        use_tri = knob == "on" or (knob == "auto" and self.device.type == "cuda")
        return DeviceGraph(*ops, num_nodes=ops[0].n_out,
                           node_map=torch.from_numpy(ops[0].node_map),
                           tri=hs.HyperShardTri(adjs=tuple(ops)) if use_tri else None)

    def _to_distributed_graph(self, graph: NgramGraph, plan: LevelPlan,
                              layout: mesh.RankLayout) -> DeviceGraph:
        """This rank's operators of a node-sharded level (trainer.py:1840-1897):
        the key-sharded hypercube under ``parallel.mode="hypercube"`` where the
        level takes it, else the halo operators."""
        par = self.config.parallel
        mode = par.mode
        if mode == "hypercube" and graph.n < 2:
            logger.info("1-gram level has no key structure; using halo mode")
            mode = "halo"
        dg = None
        if mode == "hypercube":
            dg = self._to_hyper_shard_graph(graph, layout, plan.compute_dtype)
            if dg is None:
                logger.info("hypercube sharding unavailable; using halo mode")
        if dg is None:
            dg = mesh.build_distributed_device_graph(graph, layout, par.debug_checksums,
                                                     self.device)
        logger.info("distributed level n=%d: %d node shards, %s operators (%d nodes padded "
                    "to %d)", graph.n, layout.node_shards, dg.route, graph.num_nodes,
                    dg.p_in.global_nodes)
        return dg

    def _make_cluster_batches(self, graph: NgramGraph, x: np.ndarray, y: np.ndarray,
                              seed: int, node_map: Optional[np.ndarray] = None
                              ) -> Tuple[List[ClusterBatch], bool]:
        """Cluster-GCN subgraph batches padded to one node budget
        (trainer.py:1691-1815; reference: protgram_directgcn_trainer.py:152-198).

        ``ceil(n / target_nodes_per_cluster)`` BFS parts of 𝒜_in + 𝒜_out
        (clamped to [min_clusters, max_clusters]); the budget is the largest
        part rounded up to a multiple of 8.  Blocks are dense Aᵀ
        ``[budget, budget]`` while the budget is at most
        ``cluster_dense_max_budget``, else padded ELL with one width per
        matrix across the clusters.  Returns ``(batches, resident)``: the
        batches are copied to the device while their total bytes fit
        ``cluster_device_budget_bytes``, and stay host numpy otherwise (one
        is copied a step)."""
        gcn = self.gcn
        n = graph.num_nodes
        num_clusters = int(np.ceil(n / gcn.target_nodes_per_cluster))
        num_clusters = min(max(gcn.min_clusters, num_clusters), gcn.max_clusters)
        logger.info("partitioning %d nodes into %d clusters", n, num_clusters)

        m_in, m_out, m_und = graph.mathcal_a_in(), graph.mathcal_a_out(), graph.undirected_norm()
        labels = partition_nodes((m_in + m_out).tocsr(), num_clusters, method="bfs", seed=seed)
        sizes = np.bincount(labels, minlength=num_clusters)
        budget = -(-int(sizes.max()) // 8) * 8
        dense = budget <= gcn.cluster_dense_max_budget
        cluster_nodes = [nd for nd in (np.nonzero(labels == c)[0] for c in range(num_clusters))
                         if len(nd)]

        def sub_coo(m, nodes):
            block = m[nodes][:, nodes].tocoo()
            return (block.row.astype(np.int64), block.col.astype(np.int64),
                    block.data.astype(np.float32))

        def max_deg(m):
            k = 0
            for nodes in cluster_nodes:
                r, c, _ = sub_coo(m, nodes)
                if len(c):
                    k = max(k, int(np.bincount(c).max()), int(np.bincount(r).max()))
            return max(4, -(-k // 4) * 4)

        # One ELL width per matrix across the clusters (trainer.py:1751-1761).
        k_widths = [None] * 3 if dense else [max_deg(m) for m in (m_in, m_out, m_und)]

        def make_adj(m, nodes, k):
            r, c, v = sub_coo(m, nodes)
            if dense:
                at = np.zeros((budget, budget), np.float32)
                np.add.at(at, (c, r), v)  # Aᵀ: aggregate at targets
                return DenseAdj(at=at)
            idx, w = _ell_one_sided(r, c, v, budget)
            idx_t, w_t = _ell_one_sided(c, r, v, budget)
            pad = lambda a: np.pad(a, ((0, 0), (0, k - a.shape[1])))  # noqa: E731
            return EllAdj(idx=pad(idx), w=pad(w), idx_t=pad(idx_t), w_t=pad(w_t))

        batches = []
        for nodes in cluster_nodes:
            dg = DeviceGraph(p_in=make_adj(m_in, nodes, k_widths[0]),
                             p_out=make_adj(m_out, nodes, k_widths[1]),
                             p_und=make_adj(m_und, nodes, k_widths[2]), num_nodes=budget)
            x_sub = np.zeros((budget, x.shape[1]), dtype=np.float32)
            x_sub[: len(nodes)] = x[nodes]
            y_sub = np.zeros(budget, dtype=np.int32)
            y_sub[: len(nodes)] = y[nodes]
            mask = np.zeros(budget, dtype=np.float32)
            mask[: len(nodes)] = 1.0
            # Per-node parameters live in the level's device node space.
            orig = np.zeros(budget, dtype=np.int32)
            orig[: len(nodes)] = nodes if node_map is None else node_map[nodes]
            batches.append(ClusterBatch(graph=dg, x=x_sub, y=y_sub, mask=mask,
                                        weight_factor=float(len(nodes) / n),
                                        original_indices=orig))

        total_bytes = sum(a.nbytes for b in batches for a in _batch_arrays(b))
        resident = total_bytes <= gcn.cluster_device_budget_bytes
        logger.info("cluster batches: %d x budget=%d (%s blocks) = %.2f GB total -> %s",
                    len(batches), budget, "dense" if dense else "ell", total_bytes / 1e9,
                    "device-resident" if resident else
                    f"host-streamed (budget {gcn.cluster_device_budget_bytes / 1e9:.2f} GB)")
        if resident:
            batches = [b.to_device(self.device) for b in batches]
        return batches, resident

    # ------------------------------------------------------------------

    def train_level(self, graph: NgramGraph, x_np: np.ndarray, y_np: np.ndarray,
                    num_classes: int, ckpt_dir: Optional[os.PathLike] = None,
                    metrics: Optional[MetricLogger] = None
                    ) -> Tuple[dict, np.ndarray, DirectGCNConfig, DeviceGraph]:
        """Train one n-gram level, full batch or on Cluster-GCN batches;
        returns (params, node embeddings of the real nodes, model config,
        device graph of the full level).

        Full batch (trainer.py:2050-2084): with ``ckpt_dir`` and
        ``gcn.checkpoint_every_epochs`` > 0, the latest ``step_{k}`` there is
        restored before the first epoch (training goes on at epoch k + 1) and
        the state is saved every ``checkpoint_every_epochs`` epochs; the
        plateau scheduler and the early stopper start afresh, as in the JAX
        package, while the learning rate rides in the optimizer's state and
        the dropout generator's state in ``extra``.  ``metrics`` logs
        ``{"level", "loss", "lr"}`` each epoch at ``step=epoch``.  The
        clustered loop neither checkpoints nor logs.

        Under ``parallel.mesh_nodes`` (one process a node shard,
        ``parallel/``) the level trains full batch over the shards
        (trainer.py:1835-1934, 2031-2049): ``parallel.mode`` "hypercube"
        takes the key-sharded hypercube where the level has one (n >= 2),
        else and under "halo" the halo operators; per-path remat, the staged
        step and cluster training are off; each rank keeps its node rows of
        the parameters and inputs, initialised from the whole level's draws;
        the checkpoint holds the whole level's state (rank 0 writes it, each
        rank restores its rows); the embeddings are gathered on every rank.
        The dropout masks come from a generator of each rank's own."""
        gcn = self.gcn
        dev = self.device
        n_val = graph.n
        feat_dim = x_np.shape[1]
        layout = self._rank_layout()
        plan = self._level_plan(graph, feat_dim, num_classes)
        if layout is not None and (plan.remat_paths or plan.stage_split):
            plan = dataclasses.replace(plan, remat_paths=False, stage_split=0)
        # The degrade policy's dims replace the configured ones (trainer.py:1830-1833).
        hidden = plan.layer_dims_override or tuple(gcn.hidden_layer_dims)
        layer_dims = tuple([feat_dim] + list(hidden))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t_ops = time.monotonic()
        shard: Optional[NodeShard] = None
        if layout is not None:
            full_graph = self._to_distributed_graph(graph, plan, layout)
            shard = NodeShard(full_graph.p_in, int(full_graph.p_in.global_nodes))
            total_nodes = shard.n_global
        else:
            # The format's byte model sees the widest layer (trainer.py:1899).
            full_graph = self._to_device_graph(graph, plan, max(layer_dims))
            total_nodes = full_graph.num_nodes
        operator_seconds = time.monotonic() - t_ops
        node_map = None if full_graph.node_map is None else full_graph.node_map.cpu().numpy()

        use_cluster = (gcn.use_cluster_training
                       and graph.num_nodes > gcn.cluster_training_threshold_nodes)
        if use_cluster and shard is not None:
            logger.info("cluster training off under node sharding (full batch over the shards)")
            use_cluster = False
        if use_cluster and gcn.cluster_auto_fullbatch and full_graph.route == "hypercube":
            logger.info("auto-routing n=%d to full-batch (hypercube operators built)", n_val)
            use_cluster = False

        def pad_nodes(arr: np.ndarray) -> np.ndarray:
            """Scatter real-node rows into the device graph's node space (the
            shard padding: zero rows at the end)."""
            if node_map is None and arr.shape[0] >= total_nodes:
                return arr
            out = np.zeros((total_nodes,) + arr.shape[1:], dtype=arr.dtype)
            if node_map is None:
                out[: arr.shape[0]] = arr
            else:
                out[node_map] = arr
            return out

        model_cfg = DirectGCNConfig(
            layer_dims=layer_dims,
            num_nodes=total_nodes,
            num_classes=num_classes,
            n_gram_len=n_val,
            one_gram_dim=(gcn.one_gram_init_dim if n_val == 1 else 0),
            max_pe_len=gcn.max_pe_len,
            dropout=gcn.dropout_rate,
            use_vector_coeffs=gcn.use_vector_coeffs,
            remat=plan.remat,
            remat_paths=plan.remat_paths,
            compute_dtype=plan.compute_dtype,
            node_param_dtype=plan.node_param_dtype,
        )
        init_gen = torch.Generator(device=dev).manual_seed(self.config.random_state + n_val)
        params = init_directgcn_params(init_gen, model_cfg, device=dev)
        if shard is not None:  # trainer.py:1931-1934
            params = mesh.shard_model_params(params, shard.adj.node_rows(), shard.n_global)
        else:
            params = _node_params_to_rg(params, full_graph)
        for p in param_leaves(params):
            p.requires_grad_(True)

        l2_lambda = gcn.l2_reg_lambda
        wd = gcn.weight_decay if l2_lambda <= 0 else 0.0
        if plan.factored:
            logger.info("level n=%d: per-node tables train with factored (Adafactor) second "
                        "moments (node_param_factored=%s)", n_val, gcn.node_param_factored)
        local_nodes = total_nodes if shard is None else shard.n_local
        opt = make_optimizer(params, gcn.lr, wd,
                             factor_node_params_above=local_nodes if plan.factored else None,
                             n_global=None if shard is None else shard.n_global)
        # A stage per layer (trainer.py:1952-1958); Cluster-GCN batches are
        # small and train fused (the JAX staged step takes no subgraph batch).
        staged = bool(plan.stage_split) and not use_cluster
        if shard is not None:
            mask_total = float(graph.num_nodes)
            step = make_train_step_sharded(model_cfg, opt, l2_lambda, shard, mask_total)
        else:
            step = (make_train_step_staged if staged else make_train_step)(model_cfg, opt,
                                                                            l2_lambda)
        sched = (PlateauScheduler(gcn.lr, gcn.lr_scheduler_patience, gcn.lr_scheduler_factor)
                 if gcn.use_lr_scheduler else None)
        stopper = (EarlyStopper(gcn.early_stopping_patience, gcn.early_stopping_min_delta)
                   if gcn.use_early_stopping else None)
        # On the host: a step draws its masks' seeds without a device sync;
        # one generator a rank.
        drop_gen = torch.Generator().manual_seed(
            self.config.random_state * 7919 + n_val + 104729 * comm.rank())

        def end_epoch(epoch: int, loss: float) -> bool:
            """Step the plateau scheduler; True where early stopping ends the level."""
            if sched is not None:
                set_learning_rate(opt, sched.step(loss))
            if stopper is not None and stopper.should_stop(loss):
                logger.info("early stop at epoch %d (best %.5f)", epoch, stopper.best_loss)
                return True
            return False

        stats: Dict[str, Any] = {"route": "cluster" if use_cluster else full_graph.route,
                                 "staged": staged, "layer_dims": list(layer_dims)}
        if shard is not None:
            stats.update(world_size=layout.node_shards, rank=layout.rank,
                         rank_nodes=shard.n_local)
        losses: List[float] = []
        if use_cluster:
            t_build = time.monotonic()
            batches, resident = self._make_cluster_batches(
                graph, x_np, y_np, self.config.random_state, node_map=node_map)
            stats.update(clusters=len(batches), budget=int(batches[0].x.shape[0]),
                         block_format=("dense" if isinstance(batches[0].graph.p_in, DenseAdj)
                                       else "ell"),
                         resident=resident, cluster_build_seconds=time.monotonic() - t_build)
            shuffle_rng = np.random.default_rng(self.config.random_state + n_val)
            launches0 = _launch_counts()
            t0 = time.monotonic()
            for epoch in range(1, gcn.epochs_per_level + 1):
                batch_losses = []
                for bi in shuffle_rng.permutation(len(batches)):
                    # Streaming: this batch alone is copied to the device.
                    b = batches[bi] if resident else batches[bi].to_device(dev)
                    batch_losses.append(step(params, b.graph, b.x, b.y, b.mask, b.weight_factor,
                                             drop_gen, b.original_indices)[0])
                # One read-back an epoch, summed in batch order as the JAX
                # loop sums float(loss) of each batch (trainer.py:2000-2005).
                epoch_loss = 0.0
                for v in torch.stack(batch_losses).tolist():
                    epoch_loss += v
                losses.append(epoch_loss / len(batches))
                if end_epoch(epoch, losses[-1]):
                    break
            stats["steps"] = len(losses) * len(batches)
            del batches
        else:
            # The input in the compute type (trainer.py:2031-2032), rg on the
            # hypercube; a shard's rows of it (trainer.py:2040-2049).
            x_dtype = torch.bfloat16 if plan.compute_dtype == "bfloat16" else torch.float32
            ones = np.ones(graph.num_nodes, dtype=np.float32)
            if shard is not None:
                x, y, mask = mesh.shard_training_inputs(
                    pad_nodes(x_np.astype(np.float32)), pad_nodes(y_np.astype(np.int64)),
                    pad_nodes(ones), shard.adj, dev, x_dtype)
            else:
                x = torch.from_numpy(pad_nodes(x_np.astype(np.float32))).to(dev).to(x_dtype)
                if full_graph.route == "hypercube":
                    x = x.reshape(full_graph.p_in.feature_shape + (feat_dim,))
                y = torch.from_numpy(pad_nodes(y_np.astype(np.int64))).to(dev)
                mask = torch.from_numpy(pad_nodes(ones)).to(dev)
            every = gcn.checkpoint_every_epochs if ckpt_dir is not None else 0
            start_epoch = 1
            if every > 0:
                restored = ckpt.restore_train_state(ckpt_dir, params, opt, shard=shard)
                if restored is not None:
                    start_epoch = restored[0] + 1
                    drop_gen.set_state(restored[1]["dropout_generator"])
            stats["start_epoch"] = start_epoch
            launches0 = _launch_counts()
            t0 = time.monotonic()
            for epoch in range(start_epoch, gcn.epochs_per_level + 1):
                loss, _ = step(params, full_graph, x, y, mask, 1.0, drop_gen)
                losses.append(float(loss))
                if metrics is not None:
                    metrics.log_metrics({"level": n_val, "loss": losses[-1],
                                         "lr": sched.lr if sched else gcn.lr}, step=epoch)
                if end_epoch(epoch, losses[-1]):
                    break
                if every > 0 and epoch % every == 0:
                    ckpt.save_train_state(ckpt_dir, epoch, params, opt,
                                          {"dropout_generator": drop_gen.get_state()},
                                          shard=shard)
            stats["steps"] = len(losses)
            del x
        seconds = time.monotonic() - t0
        launches1 = _launch_counts()
        logger.info("n=%d %s training on %s (%s operators): %d epochs in %.2fs "
                    "(final loss %.5f)", n_val, stats["route"], dev, full_graph.route,
                    len(losses), seconds, losses[-1] if losses else float("nan"))
        del opt, step

        # Eval-mode embeddings on the full graph (reference: models_utils.py:264-273).
        t_eval = time.monotonic()
        x_eval = pad_nodes(x_np.astype(np.float32))
        with torch.no_grad():
            if shard is not None:
                x_eval = mesh.shard_training_inputs(x_eval, np.zeros(total_nodes, np.int64),
                                                    np.zeros(total_nodes, np.float32),
                                                    shard.adj, dev)[0]
                _, embeds = directgcn_apply(params, full_graph, x_eval, model_cfg, train=False)
                embeds = shard.gather(embeds)
            else:
                _, embeds = directgcn_apply(params, full_graph, torch.from_numpy(x_eval).to(dev),
                                            model_cfg, train=False)
        embeds = embeds.cpu().numpy()
        if node_map is not None:
            embeds = embeds[node_map]
        elif embeds.shape[0] > graph.num_nodes:  # the shard padding's rows
            embeds = embeds[: graph.num_nodes]
        eval_seconds = time.monotonic() - t_eval
        launches2 = _launch_counts()
        self.level_stats[n_val] = {
            **stats,
            "plan": dataclasses.asdict(plan),
            "nodes": graph.num_nodes,
            "device_nodes": total_nodes,
            "epochs": len(losses),
            "losses": losses,
            "operator_seconds": operator_seconds,  # host build + copy of the operators
            "train_seconds": seconds,
            "eval_seconds": eval_seconds,  # eval pass and copy of the embeddings to the host
            # Training's kernel launches, and the eval pass's.
            "launches": _launch_diff(launches0, launches1),
            "eval_launches": _launch_diff(launches1, launches2),
            # From the operators' build to the eval pass (None off the card).
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
        }
        return params, embeds, model_cfg, full_graph

    # ------------------------------------------------------------------

    def run(self, fasta_path: Optional[os.PathLike] = None,
            graphs_dir: Optional[os.PathLike] = None,
            output_dir: Optional[os.PathLike] = None) -> Optional[str]:
        """Train every level, cascade features, checkpoint each level's
        embeddings to ``level_{n}.npz`` (and resume from them; within a level
        the training state, ``train_state_n{n}``), log each level's
        parameters and metrics (``run_n{n}``), mean-pool the
        final level's embeddings per protein (kept as ``self.pooled``), and
        write them to ``gcn_n{n}_embeddings`` and, under ``gcn.apply_pca``,
        their PCA to ``gcn_n{n}_embeddings_pca{dim}`` (``.h5``, or ``.npz``
        where h5py is absent), then, under ``gcn.run_sanity_check_ppi``, run
        the PPI sanity check on that file (``self.sanity_metrics``)
        (trainer.py:2164-2204).  Returns the path of the last file written,
        or None when the final level is missing.  Node-sharded, every rank
        trains every level and rank 0 alone writes files, pools and runs the
        sanity check (the other ranks return None)."""
        cfg = self.config
        self.pooled = None
        self.sanity_metrics, self.sanity_stats = None, {}
        fasta_path = fasta_path or cfg.paths.input_fasta
        graphs_dir = graphs_dir or cfg.paths.graph_objects_dir
        output_dir = ensure_dir(output_dir or cfg.paths.gcn_embeddings_dir)
        ckpt_dir = ensure_dir(os.path.join(str(output_dir), "level_checkpoints"))

        main = comm.is_main()
        if cfg.id_mapping_mode not in ("regex", "none"):
            raise NotImplementedError(f"id_mapping_mode={cfg.id_mapping_mode!r} is not ported")
        if cfg.id_mapping_mode == "regex" and main:
            self.id_map = generate_regex_id_map(fasta_path, cfg.paths.id_mapping_output_file)
            logger.info("loaded %d ID mappings", len(self.id_map))

        level_embeds: Dict[int, np.ndarray] = {}
        level_vocab: Dict[int, np.ndarray] = {}
        n_max = cfg.graph_builder.ngram_max_n

        for n_val in range(1, n_max + 1):
            ckpt_path = os.path.join(str(ckpt_dir), f"level_{n_val}.npz")
            graph_path = os.path.join(str(graphs_dir), f"ngram_graph_n{n_val}.npz")
            if not os.path.exists(graph_path):
                logger.error("graph artifact missing for n=%d: %s", n_val, graph_path)
                continue
            graph = load_graph(graph_path)
            if graph.num_nodes == 0:
                logger.warning("skipping n=%d (empty graph)", n_val)
                continue
            level_vocab[n_val] = graph.vocab

            if os.path.exists(ckpt_path):
                with np.load(ckpt_path, allow_pickle=False) as z:
                    level_embeds[n_val] = z["embeddings"]
                logger.info("resumed n=%d from checkpoint (%s)", n_val, ckpt_path)
                continue

            t_level = time.monotonic()
            task = self.gcn.task_types_per_level.get(n_val, self.gcn.default_task_type)
            logger.info("=== level n=%d: %d nodes, task=%s ===", n_val, graph.num_nodes, task)
            prev_vocab = level_vocab.get(n_val - 1)
            prev_embeds = level_embeds.get(n_val - 1)
            if n_val > 1 and (prev_embeds is None or prev_embeds.size == 0):
                logger.error("previous level embeddings missing for n=%d; skipping", n_val)
                continue
            x = self._initial_features(graph, prev_vocab, prev_embeds, cfg.random_state + n_val)
            t_labels = time.monotonic()
            y, num_classes = generate_labels(graph, task, self.gcn.closest_aa_k_hops,
                                             cfg.random_state)
            label_seconds = time.monotonic() - t_labels
            # Keep only the embeddings: the level's operators and parameters
            # leave the device before the next level.
            with (MetricLogger(os.path.join(str(ckpt_dir), f"run_n{n_val}"), f"gcn_n{n_val}")
                  if main else contextlib.nullcontext()) as metrics:
                if metrics is not None:
                    metrics.log_params({"level": n_val, "task": task,
                                        "num_nodes": graph.num_nodes,
                                        "num_edges": graph.num_edges,
                                        "num_classes": num_classes})
                embeds = self.train_level(
                    graph, x, y, num_classes, metrics=metrics,
                    ckpt_dir=os.path.join(str(ckpt_dir), f"train_state_n{n_val}"))[1]
            level_embeds[n_val] = embeds
            if main:
                np.savez_compressed(ckpt_path, embeddings=embeds)
            st = self.level_stats[n_val]
            st.update(task=task, num_classes=num_classes)
            if task == "community":
                st["louvain_seconds"] = label_seconds
            # Features, labels, operators, training, eval pass and checkpoint.
            st["level_seconds"] = time.monotonic() - t_level

        if n_max not in level_embeds or level_embeds[n_max].size == 0:
            logger.error("final level n=%d embeddings missing; cannot pool", n_max)
            return None
        if not main:
            return None

        # Pool n-gram embeddings to proteins and rename ids
        # (reference: protgram_directgcn_trainer.py:387-421).
        t_pool = time.monotonic()
        sequences = list(parse_fasta(fasta_path))
        pooled = emb_utils.pool_ngram_embeddings_for_proteins(
            sequences, n_max, level_vocab[n_max], level_embeds[n_max]
        )
        if self.id_map:
            pooled = {self.id_map.get(k, k): v for k, v in pooled.items()}
        self.pool_seconds = time.monotonic() - t_pool
        self.pooled = pooled
        final_path = write_embeddings(
            os.path.join(str(output_dir), f"gcn_n{n_max}_embeddings.h5"), pooled)
        logger.info("primary embeddings saved to %s (%d proteins)", final_path, len(pooled))
        if self.gcn.apply_pca and pooled:
            pca = emb_utils.apply_pca(pooled, self.gcn.pca_target_dim, cfg.random_state)
            if pca:
                dim = next(iter(pca.values())).shape[0]
                final_path = write_embeddings(
                    os.path.join(str(output_dir), f"gcn_n{n_max}_embeddings_pca{dim}.h5"), pca)
                logger.info("PCA embeddings saved to %s", final_path)
        if self.gcn.run_sanity_check_ppi:
            self.sanity_metrics = run_sanity_check_ppi(cfg, final_path, device=self.device,
                                                       stats=self.sanity_stats)
        return final_path
