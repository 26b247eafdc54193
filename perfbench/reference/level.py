"""The reference level: the graph of the FASTA and the configuration's node
space, shared by every model (``graph_level``); DirectGCN's three operators
on it (``with_operators``); and DirectGCN's first steps of full-batch
training from a seed.  Imports NumPy, PyTorch and this folder only.

The seed prescribes the drawing: the weights from a device generator
seeded ``seed + n``, the dropout seeds from a host generator seeded
``seed * 7919 + n`` (``model.py`` gives the order of the draws).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from perfbench.reference import graph as ref_graph
from perfbench.reference import model as ref_model


@dataclasses.dataclass
class Level:
    n: int
    num_nodes: int  # real nodes
    n_space: int  # rows of the node space
    positions: torch.Tensor  # [num_nodes] row of each real node
    graph: ref_graph.Graph  # the vocabulary and the edge list (src, tgt, pair counts)
    ops: Tuple[ref_model.SparseOperator, ...] = ()  # DirectGCN's: in, out, undirected

    @property
    def nnz(self) -> Tuple[int, ...]:
        return tuple(op.nnz for op in self.ops)


def graph_level(fasta: str, n: int, node_space: str, device) -> Level:
    """The n-gram graph of ``fasta`` placed on the node space, no operators."""
    g = ref_graph.ngram_graph(ref_graph.read_fasta(fasta), n, device)
    if node_space == "hypercube":
        positions, n_space = g.hypercube_positions()
    elif node_space == "vocabulary":
        positions, n_space = torch.arange(g.num_nodes, device=device), g.num_nodes
    else:
        raise ValueError(f"unknown node space {node_space!r}")
    return Level(n=n, num_nodes=g.num_nodes, n_space=n_space, positions=positions, graph=g)


def with_operators(level: Level, eps: float) -> Level:
    """``level`` with DirectGCN's three operators on its node space."""
    ops = tuple(ref_model.SparseOperator(e, level.positions, level.n_space)
                for e in ref_graph.operators(level.graph, eps))
    return dataclasses.replace(level, ops=ops)


def build_level(fasta: str, n: int, node_space: str, eps: float, device) -> Level:
    return with_operators(graph_level(fasta, n, node_space, device), eps)


@contextlib.contextmanager
def _tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def first_steps(level: Level, cfg: dict, x: np.ndarray, y: np.ndarray, num_classes: int,
                seed: int, steps: int, device, tf32: bool = False,
                half_batch: bool = False) -> Dict[str, object]:
    """``steps`` full-batch steps of the configured model on ``level`` from
    ``seed``; see ``model.train_steps``.  ``tf32``: the projections in TF32
    (the control); ``half_batch``: the loss's mean over every other real
    node only (a planted fault)."""
    gcn = cfg["gcn"]
    dims = [x.shape[1]] + list(gcn["hidden_layer_dims"])
    pos = level.positions
    xs = torch.zeros((level.n_space, x.shape[1]), device=device)
    xs[pos] = torch.from_numpy(x).to(device)
    ys = torch.zeros(level.n_space, dtype=torch.int64, device=device)
    ys[pos] = torch.from_numpy(y).to(device)
    mask = torch.zeros(level.n_space, device=device)
    mask[pos[::2] if half_batch else pos] = 1.0
    params = ref_model.init_params(seed + level.n, dims, level.n_space, num_classes, device)
    seed_gen = torch.Generator().manual_seed(seed * 7919 + level.n)
    with _tf32(tf32):
        return ref_model.train_steps(params, level.ops, xs, ys, mask, steps, gcn["lr"],
                                     gcn["l2_reg_lambda"], gcn["dropout_rate"],
                                     cfg["decoder_dropout"], seed_gen)

