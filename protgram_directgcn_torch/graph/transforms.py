"""Graph normalization / propagation-matrix transforms.

Host-side (numpy/scipy) implementations of the DirectGCN propagation math.
These run once per graph at build/load time; the training hot loop only sees
the resulting static arrays.

Reference semantics reproduced exactly (for allclose parity):

- row normalization  A_n = D^-1 A_w        (reference: graph_utils.py:231-241)
- propagation matrix 𝒜 = sqrt(0.5·(A_n∘² + A_n∘²ᵀ) + ε) + I, where ∘² is the
  elementwise square of stored values, the sum is over the union sparsity
  pattern, ε is added only at stored positions, and I adds 1 to the diagonal
  (reference: graph_utils.py:198-273).  This is the memory-optimized
  elementwise form of sqrt(S∘²+K∘²+ε)+I with S/K the symmetric/skew parts.
- undirected sym-norm matrix built from *unique unweighted* symmetric edges
  plus one appended self-loop per node (duplicates retained through
  normalization, summed at the end)  (reference: graph_utils.py:160-196).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def coalesce_coo(src: np.ndarray, tgt: np.ndarray, val: np.ndarray, n: int) -> sp.csr_matrix:
    """Build a CSR matrix summing duplicate (src, tgt) entries."""
    m = sp.coo_matrix((val.astype(np.float32), (src, tgt)), shape=(n, n))
    m.sum_duplicates()
    return m.tocsr()


def row_normalize(a: sp.spmatrix) -> sp.csr_matrix:
    """A_n = D^-1 A with zero rows left at zero (reference: graph_utils.py:231-241)."""
    a = a.tocsr().astype(np.float32)
    row_sum = np.asarray(a.sum(axis=1)).ravel()
    inv = np.zeros_like(row_sum, dtype=np.float32)
    nz = row_sum != 0
    inv[nz] = 1.0 / row_sum[nz]
    d_inv = sp.diags(inv, dtype=np.float32)
    return (d_inv @ a).tocsr()


def directgcn_propagation_matrix(a_w: sp.spmatrix, epsilon: float = 1e-9) -> sp.csr_matrix:
    """𝒜 = sqrt(0.5·(A_n∘² + A_n∘²ᵀ) + ε) + I over the union sparsity pattern.

    ε is added only at stored positions of the union pattern — not globally —
    matching the reference's sparse-value arithmetic
    (reference: graph_utils.py:246-270).
    """
    n = a_w.shape[0]
    if a_w.nnz == 0:
        return sp.identity(n, dtype=np.float32, format="csr")
    a_n = row_normalize(a_w)
    p = a_n.copy()
    p.data = p.data * p.data  # elementwise square of stored values
    s = (p + p.T).tocoo()
    s.sum_duplicates()
    vals = np.sqrt(0.5 * s.data.astype(np.float32) + np.float32(epsilon))
    base = sp.csr_matrix((vals, (s.row, s.col)), shape=(n, n))
    out = (base + sp.identity(n, dtype=np.float32, format="csr")).tocsr()
    out.sum_duplicates()
    return out


def undirected_normalized_matrix(src: np.ndarray, tgt: np.ndarray, n: int) -> sp.csr_matrix:
    """Symmetric D^-1/2 (A+I) D^-1/2 from unique unweighted edges.

    Steps match reference: graph_utils.py:160-196 —
    1. unique (src, tgt) pairs (weights discarded),
    2. symmetrize and unique again,
    3. append one self-loop per node (duplicates possible),
    4. unit weights; deg computed over all entries including duplicates,
    5. normalize per entry, then coalesce (sum duplicates).
    """
    if n == 0:
        return sp.csr_matrix((0, 0), dtype=np.float32)
    if len(src):
        # Unique (src, tgt) pairs in lexicographic order, as np.unique(axis=0)
        # gives them, through the int64 key src * n + tgt (0 <= tgt < n):
        # one integer sort in place of a row sort of pairs.
        src, tgt = src.astype(np.int64), tgt.astype(np.int64)
        keys = np.unique(src * n + tgt)
        rows, cols = keys // n, keys % n
        sym = np.unique(np.concatenate([keys, cols * n + rows]))
        rows, cols = sym // n, sym % n
    else:
        rows = np.empty(0, dtype=np.int64)
        cols = np.empty(0, dtype=np.int64)
    loops = np.arange(n, dtype=np.int64)
    rows = np.concatenate([rows, loops])
    cols = np.concatenate([cols, loops])
    deg = np.bincount(cols, minlength=n).astype(np.float32)
    with np.errstate(divide="ignore"):
        dinv = deg ** -0.5
    dinv[~np.isfinite(dinv)] = 0.0
    vals = dinv[rows] * dinv[cols]
    m = sp.coo_matrix((vals.astype(np.float32), (rows, cols)), shape=(n, n))
    m.sum_duplicates()
    return m.tocsr()


def csr_to_coo_arrays(m: sp.spmatrix):
    """Return (src, tgt, val) int32/int32/float32 arrays in row-major order."""
    c = m.tocoo()
    order = np.lexsort((c.col, c.row))
    return (
        c.row[order].astype(np.int32),
        c.col[order].astype(np.int32),
        c.data[order].astype(np.float32),
    )
