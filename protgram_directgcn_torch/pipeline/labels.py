"""Self-supervised task labels for hierarchical GCN training.

Port of protgram_directgcn_tpu/pipeline/labels.py:24-117: ``next_node``,
``community`` (Louvain, graph/community.py) and ``closest_aa``, the same
labels byte for byte.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from protgram_directgcn_torch.graph.community import louvain_communities
from protgram_directgcn_torch.graph.structure import NgramGraph

AMINO_ACID_ALPHABET = list("ACDEFGHIKLMNPQRSTVWY")


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


def community_labels(graph: NgramGraph, seed: int = 42) -> Tuple[np.ndarray, int]:
    """Louvain communities of A_in_w + A_out_w treated as undirected
    (reference: protgram_directgcn_trainer.py:200-220)."""
    n = graph.num_nodes
    if n == 0:
        return np.empty(0, dtype=np.int64), 1
    a_out = sp.coo_matrix((graph.weight, (graph.src, graph.tgt)), shape=(n, n)).tocsr()
    combined = a_out + a_out.T
    if combined.nnz == 0:
        return np.zeros(n, dtype=np.int64), 1
    labels = louvain_communities(combined, seed=seed)
    return labels, int(labels.max()) + 1


def closest_aa_labels(graph: NgramGraph, k_hops: int, seed: int = 42) -> Tuple[np.ndarray, int]:
    """label[v] = min hops (<= k) along out-edges to a node whose n-gram
    contains v's random target amino acid (drawn from a numpy generator
    seeded with ``seed``); k if unreachable within k.  num_classes = k + 1
    (reference: protgram_directgcn_trainer.py:239-269).  k rounds of a
    boolean sparse product over all 20 letters at once."""
    n = graph.num_nodes
    if n == 0:
        return np.empty(0, dtype=np.int64), k_hops + 1
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, len(AMINO_ACID_ALPHABET), n)
    vocab_chars = graph.vocab.view(np.uint32).reshape(n, -1)  # unicode code points
    letters = np.array([ord(c) for c in AMINO_ACID_ALPHABET], dtype=np.uint32)
    contains = (vocab_chars[:, :, None] == letters[None, None, :]).any(axis=1)  # [N, 20]
    if k_hops <= 0:
        labels = np.where(contains[np.arange(n), targets], 0, k_hops)
        return labels.astype(np.int64), k_hops + 1

    a_bool = sp.coo_matrix(
        (np.ones(len(graph.src), dtype=np.float64), (graph.src, graph.tgt)), shape=(n, n)
    ).tocsr()
    # dist[v, a]: the first hop that reaches letter a; k stands for "not yet".
    reach = contains.copy()
    dist = np.where(contains, 0, k_hops).astype(np.int64)
    for h in range(1, k_hops + 1):
        new_reach = (a_bool @ reach.astype(np.float64)) > 0
        newly = new_reach & ~reach
        dist = np.where(newly & (dist == k_hops), h, dist)
        reach |= new_reach
        if not newly.any():
            break
    labels = dist[np.arange(n), targets]
    return labels.astype(np.int64), k_hops + 1


def generate_labels(graph: NgramGraph, task_type: str, k_hops: int = 3,
                    seed: int = 42) -> Tuple[np.ndarray, int]:
    if task_type == "next_node":
        return next_node_labels(graph, seed)
    if task_type == "community":
        return community_labels(graph, seed)
    if task_type == "closest_aa":
        return closest_aa_labels(graph, k_hops, seed)
    raise ValueError(f"Unsupported task type: {task_type}")
