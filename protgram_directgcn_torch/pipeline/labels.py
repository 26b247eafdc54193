"""Self-supervised task labels for hierarchical GCN training.

Port of protgram_directgcn_tpu/pipeline/labels.py:27-56, 110.  Only
``next_node`` is ported; ``community`` (Louvain) and ``closest_aa`` wait for
a later slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from protgram_directgcn_torch.graph.structure import NgramGraph


def next_node_labels(graph: NgramGraph, seed: int = 42) -> Tuple[np.ndarray, int]:
    """label[i] = a max-weight successor of i (random among ties, from a
    numpy generator seeded with ``seed``); i itself if i has no out-edges.
    num_classes = num_nodes (reference: protgram_directgcn_trainer.py:222-237)."""
    n = graph.num_nodes
    if n == 0:
        return np.empty(0, dtype=np.int64), 1
    a = sp.coo_matrix((graph.weight, (graph.src, graph.tgt)), shape=(n, n))
    a.sum_duplicates()
    src, tgt, w = a.row, a.col, a.data

    labels = np.arange(n, dtype=np.int64)
    if len(src):
        rng = np.random.default_rng(seed)
        row_max = np.full(n, -np.inf)
        np.maximum.at(row_max, src, w)
        is_max = w == row_max[src]
        pri = rng.random(len(src))
        pri = np.where(is_max, pri, -1.0)
        best_pri = np.full(n, -np.inf)
        np.maximum.at(best_pri, src, pri)
        chosen = (pri == best_pri[src]) & is_max
        labels[src[chosen]] = tgt[chosen]
    return labels, n


def generate_labels(graph: NgramGraph, task_type: str, k_hops: int = 3,
                    seed: int = 42) -> Tuple[np.ndarray, int]:
    if task_type == "next_node":
        return next_node_labels(graph, seed)
    if task_type in ("community", "closest_aa"):
        raise NotImplementedError(
            f"task {task_type!r} is not ported yet (ROADMAP Queue 1); use next_node"
        )
    raise ValueError(f"Unsupported task type: {task_type}")
