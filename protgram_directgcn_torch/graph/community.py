"""Louvain community detection (numpy/CSR, the sweep in C++).

Port of protgram_directgcn_tpu/graph/community.py (``_one_level:22``,
``louvain_communities:63``, ``modularity:104``; reference: python-louvain in
protgram_directgcn_trainer.py:167-170, 200-220), used for the ``community``
task labels and the ``louvain`` partitioner.

Two-phase Louvain over a weighted undirected graph: phase 1 greedily moves
nodes to the neighbouring community with the best modularity gain, in sweeps
over a seeded permutation (at most 100 a level); phase 2 aggregates the
communities into super-nodes; repeat until no node moves.

A sweep is a Python loop over every node in the JAX package, so the port
runs it in C++ (``csrc/louvain.cpp``, built by g++ at first use,
``ops/_nvcc.py``).  Python
keeps the rest: the levels, each sweep's ``rng.permutation(n)`` (numpy's
random stream), the relabelling and the scipy aggregation.  The C++ sweep
does the plain sweep's float64 arithmetic in the same order, so the labels
are byte-equal to it and to the JAX package's.  ``sweep_plain`` is the numpy
sweep, the JAX package's loop body, kept as the tests' reference and reached
only by passing it as ``sweep``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from protgram_directgcn_torch.ops import _nvcc

# (indptr, indices, data, k, self_loops, comm, comm_tot, m2, perm) -> nodes moved;
# comm and comm_tot are updated in place.
Sweep = Callable[..., int]

_MAX_SWEEPS = 100

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
BUILD_INFO: Dict[str, object] = {}


def build() -> Dict[str, object]:
    """Compile (g++) and load ``csrc/louvain.cpp`` (idempotent).  Returns
    ``{"path", "seconds", "built", "log"}``; raises if the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return BUILD_INFO
        info = _nvcc.compile_host_source("louvain")
        lib = ctypes.CDLL(str(info["path"]))
        ptr = ctypes.c_void_p
        lib.louvain_sweep.argtypes = [ctypes.c_int64, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                      ctypes.c_double, ptr]
        lib.louvain_sweep.restype = ctypes.c_int64
        BUILD_INFO.clear()
        BUILD_INFO.update(info)
        _lib = lib
        return BUILD_INFO


def _checked(a: np.ndarray, dtype, n: int, name: str) -> np.ndarray:
    if a.dtype != dtype or a.shape != (n,) or not a.flags.c_contiguous:
        raise ValueError(f"louvain sweep: {name} must be contiguous {np.dtype(dtype)} [{n}], "
                         f"got {a.dtype} {a.shape}")
    return a


def sweep_native(indptr, indices, data, k, self_loops, comm, comm_tot, m2, perm) -> int:
    """One sweep in C++ (``csrc/louvain.cpp``).  The inputs it only reads
    are converted; ``comm`` and ``comm_tot``, which it updates in place,
    must already be contiguous int64 and float64."""
    build()
    n = len(k)
    indptr = _checked(np.ascontiguousarray(indptr, dtype=np.int64), np.int64, n + 1, "indptr")
    nnz = int(indptr[-1])
    indices = np.ascontiguousarray(indices[:nnz], dtype=np.int64)
    data = _checked(np.ascontiguousarray(data[:nnz], dtype=np.float64), np.float64, nnz, "data")
    perm = _checked(np.ascontiguousarray(perm, dtype=np.int64), np.int64, n, "perm")
    for name, a in (("k", k), ("self_loops", self_loops), ("comm_tot", comm_tot)):
        _checked(a, np.float64, n, name)
    _checked(comm, np.int64, n, "comm")
    if len(indices) != nnz or (n and (perm.min() < 0 or perm.max() >= n
                                      or indices.min(initial=0) < 0
                                      or indices.max(initial=0) >= n)):
        raise ValueError("louvain sweep: node id out of range")
    return int(_lib.louvain_sweep(
        n, indptr.ctypes.data, indices.ctypes.data, data.ctypes.data, k.ctypes.data,
        self_loops.ctypes.data, comm.ctypes.data, comm_tot.ctypes.data, float(m2),
        perm.ctypes.data))


def sweep_plain(indptr, indices, data, k, self_loops, comm, comm_tot, m2, perm) -> int:
    """One sweep in numpy: the JAX package's loop body
    (graph/community.py:34-58)."""
    moved = 0
    for v in perm:
        cv = comm[v]
        lo, hi = indptr[v], indptr[v + 1]
        nbr, wts = indices[lo:hi], data[lo:hi]
        # Weights from v to each neighbouring community (self-loop left out).
        mask = nbr != v
        if not mask.any() and k[v] == self_loops[v]:
            continue
        ncomm = comm[nbr[mask]]
        nw = wts[mask]
        comm_tot[cv] -= k[v]
        uniq, inv = np.unique(ncomm, return_inverse=True)
        w_to = np.bincount(inv, weights=nw)
        # Modularity gain of joining community c: w_to(c) - k_v * tot(c) / 2m.
        gains = w_to - k[v] * comm_tot[uniq] / m2
        cv_pos = np.nonzero(uniq == cv)[0]
        stay_gain = gains[cv_pos[0]] if len(cv_pos) else -k[v] * comm_tot[cv] / m2
        best = int(np.argmax(gains)) if len(gains) else -1
        if best >= 0 and gains[best] > stay_gain + 1e-12:
            comm[v] = int(uniq[best])
            moved += 1
        comm_tot[comm[v]] += k[v]
    return moved


def _one_level(adj: sp.csr_matrix, m2: float, rng: np.random.Generator,
               sweep: Sweep) -> Tuple[np.ndarray, bool]:
    """Greedy modularity sweeps until none moves a node (at most 100).
    Returns (community, improved)."""
    n = adj.shape[0]
    comm = np.arange(n, dtype=np.int64)
    k = np.asarray(adj.sum(axis=1)).ravel()  # weighted degree (incl. self-loops)
    self_loops = adj.diagonal()
    comm_tot = k.copy()  # sum of degrees per community
    indptr, indices = adj.indptr.astype(np.int64), adj.indices.astype(np.int64)
    improved_any = False
    for _ in range(_MAX_SWEEPS):
        moved = sweep(indptr, indices, adj.data, k, self_loops, comm, comm_tot, m2,
                      rng.permutation(n))
        if moved == 0:
            break
        improved_any = True
    return comm, improved_any


def louvain_communities(adj: sp.spmatrix, seed: int = 42, max_levels: int = 20,
                        sweep: Optional[Sweep] = None) -> np.ndarray:
    """Community label per node (consecutive ints, 0..C-1).

    ``adj`` is treated as undirected: it is symmetrized to (W + Wᵀ) / 2 with
    duplicate entries summed; self-loops allowed.  ``sweep``: the C++ sweep
    unless given (``sweep_plain`` is the numpy one).
    """
    sweep = sweep_native if sweep is None else sweep
    n = adj.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)
    w = adj.tocsr().astype(np.float64)
    w = (w + w.T) / 2.0
    w.sum_duplicates()
    if w.nnz == 0:
        return np.zeros(n, dtype=np.int64)
    rng = np.random.default_rng(seed)

    labels = np.arange(n)
    current = w
    for _ in range(max_levels):
        m2 = current.sum()  # = 2m for symmetric matrices counting both triangles
        if m2 <= 0:
            break
        comm, improved = _one_level(current.tocsr(), m2, rng, sweep)
        uniq, comm = np.unique(comm, return_inverse=True)
        labels = comm[labels]
        if not improved or len(uniq) == current.shape[0]:
            break
        # Aggregate: super-node adjacency.
        c = current.tocoo()
        current = sp.coo_matrix(
            (c.data, (comm[c.row], comm[c.col])), shape=(len(uniq), len(uniq))
        ).tocsr()
        current.sum_duplicates()

    # Consecutive relabelling by sorted label (protgram_directgcn_trainer.py:214-219).
    _, out = np.unique(labels, return_inverse=True)
    return out.astype(np.int64)


def modularity(adj: sp.spmatrix, labels: np.ndarray) -> float:
    """Newman modularity of a partition (for tests and diagnostics)."""
    w = adj.tocsr().astype(np.float64)
    w = (w + w.T) / 2.0
    m2 = w.sum()
    if m2 == 0:
        return 0.0
    k = np.asarray(w.sum(axis=1)).ravel()
    c = w.tocoo()
    intra = c.data[labels[c.row] == labels[c.col]].sum()
    tot = np.bincount(labels, weights=k)
    return float(intra / m2 - np.sum((tot / m2) ** 2))
