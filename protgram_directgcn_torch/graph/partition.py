"""Graph partitioning for Cluster-GCN mini-batches.

Port of protgram_directgcn_tpu/graph/partition.py (``partition_block:28``,
``partition_bfs:33``, ``partition_louvain:81``, ``partition_nodes:97``,
``edge_cut_fraction:106``; reference: protgram_directgcn_trainer.py:152-198),
the same labels byte for byte:

- ``block``:   contiguous equal node ranges;
- ``bfs``:     seeded multi-source BFS region growing with balanced sizes;
- ``louvain``: Louvain communities bin-packed into the requested number of
               parts.
"""

from __future__ import annotations

import collections
from typing import List

import numpy as np
import scipy.sparse as sp

from protgram_directgcn_torch.graph.community import louvain_communities


def partition_block(n: int, num_parts: int) -> np.ndarray:
    """Contiguous equal ranges."""
    return np.minimum((np.arange(n) * num_parts) // max(n, 1), num_parts - 1)


def partition_bfs(adj: sp.spmatrix, num_parts: int, seed: int = 42) -> np.ndarray:
    """Balanced multi-source BFS region growing over the symmetrized graph:
    each part grows from a seeded start node, one frontier node a part a
    round, up to ceil(n / num_parts) nodes; unreached nodes go to the
    smallest part."""
    n = adj.shape[0]
    if num_parts <= 1 or n == 0:
        return np.zeros(n, dtype=np.int64)
    a = adj.tocsr()
    a = a + a.T
    indptr, indices = a.indptr, a.indices
    rng = np.random.default_rng(seed)
    target = int(np.ceil(n / num_parts))

    labels = np.full(n, -1, dtype=np.int64)
    seeds = rng.choice(n, size=num_parts, replace=False)
    frontiers: List[collections.deque] = []
    sizes = np.zeros(num_parts, dtype=np.int64)
    for p, s in enumerate(seeds):
        if labels[s] == -1:
            labels[s] = p
            sizes[p] = 1
        frontiers.append(collections.deque([s]))

    active = True
    while active:
        active = False
        for p in range(num_parts):
            if sizes[p] >= target or not frontiers[p]:
                continue
            v = frontiers[p].popleft()
            for u in indices[indptr[v] : indptr[v + 1]]:
                if labels[u] == -1 and sizes[p] < target:
                    labels[u] = p
                    sizes[p] += 1
                    frontiers[p].append(u)
            if frontiers[p]:
                active = True

    for v in np.nonzero(labels == -1)[0]:
        p = int(np.argmin(sizes))
        labels[v] = p
        sizes[p] += 1
    return labels


def partition_louvain(adj: sp.spmatrix, num_parts: int, seed: int = 42) -> np.ndarray:
    """Louvain communities greedily bin-packed into num_parts balanced parts,
    largest community first."""
    comm = louvain_communities(adj, seed=seed)
    n = len(comm)
    if n == 0:
        return comm
    sizes = np.bincount(comm)
    order = np.argsort(sizes)[::-1]
    part_sizes = np.zeros(num_parts, dtype=np.int64)
    comm_to_part = np.zeros(len(sizes), dtype=np.int64)
    for c in order:
        p = int(np.argmin(part_sizes))
        comm_to_part[c] = p
        part_sizes[p] += sizes[c]
    return comm_to_part[comm]


def partition_nodes(adj: sp.spmatrix, num_parts: int, method: str = "bfs",
                    seed: int = 42) -> np.ndarray:
    if method == "block":
        return partition_block(adj.shape[0], num_parts)
    if method == "bfs":
        return partition_bfs(adj, num_parts, seed)
    if method == "louvain":
        return partition_louvain(adj, num_parts, seed)
    raise ValueError(f"Unknown partition method: {method}")


def edge_cut_fraction(adj: sp.spmatrix, labels: np.ndarray) -> float:
    """Fraction of edges crossing partitions (diagnostic and test metric)."""
    c = adj.tocoo()
    if c.nnz == 0:
        return 0.0
    return float(np.mean(labels[c.row] != labels[c.col]))
