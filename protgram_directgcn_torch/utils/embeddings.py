"""Pooling of n-gram and residue embeddings to proteins, their PCA, and the
edge features of protein pairs.

Port of protgram_directgcn_tpu/utils/embeddings.py (reference:
models_utils.py:87-136, 138-147, 181-195, 209-262, 275-324), with sklearn's
PCA solvers (sklearn is absent on the card's machine).  ``make_edge_feature``
and ``generate_edge_features_batched`` are the host versions;
``edge_features`` builds a batch's features from device tensors with the
same numbers.  Pooling: each protein is the
mean of the embeddings of its in-vocabulary n-grams; proteins with none are
dropped.
Vectorised over the whole corpus: n-grams are packed into uint64 keys (the
graph builder's order-preserving packing) and looked up in the packed
vocabulary; the per-protein sums are one sparse-dense product, so they are
added in another order than the JAX package's per-protein loop.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from protgram_directgcn_torch.utils.io import logger


def l2_normalize(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """x / (||x|| + eps) row-wise (reference: models_utils.py:138-147)."""
    if x.ndim == 1:
        return x / (np.linalg.norm(x) + eps)
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + eps)


def pool_residue_embeddings(res: np.ndarray, strategy: str = "mean",
                            dim_if_empty: Optional[int] = None) -> np.ndarray:
    """Mean/sum/max pooling of per-residue vectors (reference: models_utils.py:181-195)."""
    if res is None or res.shape[0] == 0:
        return np.zeros(dim_if_empty, dtype=np.float32) if dim_if_empty else np.array([], np.float32)
    if strategy == "sum":
        return np.sum(res, axis=0)
    if strategy == "max":
        return np.max(res, axis=0)
    return np.mean(res, axis=0)


def make_edge_feature(emb1: np.ndarray, emb2: np.ndarray, method: str) -> np.ndarray:
    """One edge feature of two protein vectors (reference:
    models_utils.py:302-313): "average" in float32, cast to float16; the
    others in the vectors' type; any other method concatenates."""
    if method == "average":
        return ((emb1.astype(np.float32) + emb2.astype(np.float32)) / 2.0).astype(np.float16)
    if method == "hadamard":
        return emb1 * emb2
    if method == "l1_distance":
        return np.abs(emb1 - emb2)
    if method == "l2_distance":
        return (emb1 - emb2) ** 2
    return np.concatenate((emb1, emb2))


def edge_features(a: torch.Tensor, b: torch.Tensor, method: str) -> torch.Tensor:
    """:func:`make_edge_feature` on rows of float16 tensors ``[B, D]``: the
    same float16 numbers (each float16 operation rounds once, as numpy's)."""
    if method == "average":
        return ((a.float() + b.float()) / 2.0).half()
    if method == "hadamard":
        return a * b
    if method == "l1_distance":
        return (a - b).abs()
    if method == "l2_distance":
        return (a - b) ** 2
    return torch.cat((a, b), dim=1)


def generate_edge_features_batched(
    interaction_pairs: Sequence[Tuple[str, str, int]],
    protein_embeddings,
    method: str,
    batch_size: int,
    embedding_dim: int,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(features float16, labels int32) batches of the pairs whose two
    vectors exist and are ``embedding_dim`` wide (reference:
    models_utils.py:275-324)."""
    feats: List[np.ndarray] = []
    labels: List[int] = []
    for p1, p2, label in interaction_pairs:
        e1 = protein_embeddings.get(p1)
        e2 = protein_embeddings.get(p2)
        if e1 is None or e2 is None or e1.size == 0 or e2.size == 0:
            continue
        if e1.shape[0] != embedding_dim or e2.shape[0] != embedding_dim:
            continue
        feats.append(make_edge_feature(e1, e2, method))
        labels.append(label)
        if len(feats) == batch_size:
            yield np.array(feats, np.float16), np.array(labels, np.int32)
            feats, labels = [], []
    if feats:
        yield np.array(feats, np.float16), np.array(labels, np.int32)


def _is_constant_feature(var: torch.Tensor, mean: torch.Tensor, n: int) -> torch.Tensor:
    """sklearn's ``_is_constant_feature``: a variance within float64's
    rounding of zero."""
    eps = torch.finfo(torch.float64).eps
    return var <= n * eps * var + (n * mean * eps) ** 2


def _pca_solver(n_samples: int, dim: int, k: int) -> str:
    """sklearn 1.9's ``PCA(svd_solver="auto")`` choice (``PCA._fit``)."""
    if dim <= 1_000 and n_samples >= 10 * dim:
        return "covariance_eigh"
    if max(n_samples, dim) <= 500:
        return "full"
    if 1 <= k < 0.8 * min(n_samples, dim):
        return "randomized"
    return "full"


def _scale_like_sklearn(mat: np.ndarray) -> np.ndarray:
    """``StandardScaler().fit_transform`` in the input's type: column means
    and population variances summed in float64 (sklearn's
    ``_incremental_mean_and_var``), then ``x -= mean``, ``x /= std`` in the
    input's type, a constant column divided by 1."""
    n = mat.shape[0]
    total = mat.sum(axis=0, dtype=np.float64)
    mean = total / n
    temp = mat - mean
    correction = temp.sum(axis=0)
    temp **= 2
    var = (temp.sum(axis=0) - correction**2 / n) / n
    std = np.sqrt(var)
    std[_is_constant_feature(torch.from_numpy(var), torch.from_numpy(mean), n).numpy()] = 1.0
    out = mat.copy()
    out -= mean.astype(mat.dtype)
    out /= std.astype(mat.dtype)
    return out


def _svd_flip_rows(u: np.ndarray, vt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn's ``svd_flip(u, vt, u_based_decision=False)``: each row of vt
    made positive at its largest magnitude, u's columns to match."""
    signs = np.sign(vt[np.arange(vt.shape[0]), np.abs(vt).argmax(axis=1)])
    return u * signs[None, :], vt * signs[:, None]


def randomized_svd(m: np.ndarray, k: int, random_state, n_oversamples: int = 10):
    """sklearn 1.9's ``_randomized_svd`` as ``PCA`` calls it (Halko et al.):
    a Gaussian sketch of k + ``n_oversamples`` columns from
    ``RandomState(random_state)`` in m's type, 7 power iterations where
    k < 0.1 * min(m.shape) else 4, each normalised by ``scipy.linalg.lu``,
    then QR and the SVD of the projection; the wide case works on mᵀ.
    Returns (u, s, vt) of the k leading components, unflipped."""
    import scipy.linalg as sla

    rng = random_state if isinstance(random_state, np.random.RandomState) else (
        np.random.RandomState(random_state))
    n_iter = 7 if k < 0.1 * min(m.shape) else 4
    transpose = m.shape[0] < m.shape[1]
    a = m.T if transpose else m
    q = rng.normal(size=(a.shape[1], k + n_oversamples))
    if a.dtype == np.float32:
        q = q.astype(np.float32, copy=False)
    for _ in range(n_iter):
        q, _ = sla.lu(a @ q, permute_l=True, check_finite=False)
        q, _ = sla.lu(a.T @ q, permute_l=True, check_finite=False)
    q, _ = sla.qr(a @ q, mode="economic", check_finite=False)
    u_hat, s, vt = sla.svd(q.T @ a, full_matrices=False, lapack_driver="gesdd")
    u = q @ u_hat
    if transpose:
        return vt[:k, :].T, s[:k], u[:, :k].T
    return u[:, :k], s[:k], vt[:k, :]


def apply_pca(embeddings: Dict[str, np.ndarray], target_dim: int,
              random_state: Optional[int] = None,
              output_dtype=np.float16) -> Optional[Dict[str, np.ndarray]]:
    """StandardScaler then PCA to ``min(target_dim, dim, n_samples)``
    components, float16 output (utils/embeddings.py:23-55 of the JAX
    package, which calls sklearn on float32 with ``random_state``).

    The solver is sklearn 1.9's "auto" choice (``_pca_solver``).  Where it
    is randomized (max(N, D) > 500, N < 10·D, k < 0.8·min(N, D)), sklearn's
    steps in numpy/scipy on the float32 matrix: the scaling
    (``_scale_like_sklearn``), centring, :func:`randomized_svd` seeded by
    ``random_state``, ``svd_flip``, scores u·s.  Elsewhere (covariance_eigh
    and full, whose exact results agree to rounding) torch on the host in
    float64: the columns centred and divided by their population std (a
    constant column by 1), ``torch.linalg.svd``, and each component's sign
    making its largest-magnitude loading positive (sklearn's
    ``svd_flip(u_based_decision=False)``)."""
    items = [(k, v.astype(np.float32)) for k, v in embeddings.items()
             if v is not None and v.size > 0]
    if not items:
        logger.error("PCA: no valid embeddings provided")
        return None
    ids = [k for k, _ in items]
    mat32 = np.stack([v for _, v in items])
    n_samples, dim = mat32.shape
    actual = min(target_dim, dim, n_samples)
    if actual <= 0:
        return {k: v.astype(output_dtype) for k, v in items}
    if actual < target_dim:
        logger.warning("PCA: adjusted target dim %d -> %d", target_dim, actual)
    solver = _pca_solver(n_samples, dim, actual)
    if solver == "randomized":
        scaled = _scale_like_sklearn(mat32)
        centred = scaled - scaled.mean(axis=0)
        u, s, vt = randomized_svd(centred, actual, random_state)
        u, _ = _svd_flip_rows(u, vt)
        out = u * s
        total = float(np.sum(centred.astype(np.float64) ** 2))
        explained = float(np.sum(s.astype(np.float64) ** 2)) / total if total else 0.0
    else:
        mat = torch.from_numpy(mat32).double()
        mean = mat.mean(0)
        var = mat.var(0, correction=0)
        std = torch.where(_is_constant_feature(var, mean, n_samples), 1.0, var.sqrt())
        scaled = (mat - mean) / std
        centred = scaled - scaled.mean(0)
        _, s, vt = torch.linalg.svd(centred, full_matrices=False)
        rows = torch.arange(vt.shape[0])
        vt = vt * torch.sign(vt[rows, vt.abs().argmax(1)])[:, None]
        out = (centred @ vt[:actual].T).numpy()
        total = float((s ** 2).sum())
        explained = float((s[:actual] ** 2).sum()) / total if total else 0.0
    logger.info("PCA %s -> %s (%s, explained variance %.4f)", tuple(mat32.shape),
                tuple(out.shape), solver, explained)
    out = out.astype(output_dtype)
    return {pid: vec for pid, vec in zip(ids, out)}


def _pack_strings(strings: np.ndarray, n: int) -> np.ndarray:
    b = np.frombuffer("".join(strings.tolist()).encode("latin-1"), np.uint8).reshape(-1, n)
    keys = np.zeros(len(b), dtype=np.uint64)
    for i in range(n):
        keys = (keys << np.uint64(8)) | b[:, i].astype(np.uint64)
    return keys


def pool_ngram_embeddings_for_proteins(
    protein_sequences: Sequence[Tuple[str, str]],
    n_val: int,
    vocab: np.ndarray,
    ngram_embeddings: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Mean-pool n-gram node embeddings to per-protein vectors."""
    if not protein_sequences or len(vocab) == 0:
        return {}
    lens = np.array([len(s) for _, s in protein_sequences], dtype=np.int64)
    buf = np.frombuffer("".join(s for _, s in protein_sequences).encode("latin-1"), np.uint8)
    n_win = np.maximum(lens - n_val + 1, 0)
    if n_win.sum() == 0:
        return {}
    # Window start positions of each protein inside the concatenated buffer.
    seq_start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    prot = np.repeat(np.arange(len(lens)), n_win)
    starts = np.repeat(seq_start, n_win) + (
        np.arange(n_win.sum()) - np.repeat(np.cumsum(n_win) - n_win, n_win)
    )
    keys = np.zeros(len(starts), dtype=np.uint64)
    for i in range(n_val):
        keys = (keys << np.uint64(8)) | buf[starts + i].astype(np.uint64)

    vocab_keys = _pack_strings(np.asarray(vocab), n_val)
    pos = np.clip(np.searchsorted(vocab_keys, keys), 0, len(vocab) - 1)
    found = vocab_keys[pos] == keys
    prot, ids = prot[found], pos[found]
    counts = np.bincount(prot, minlength=len(lens))
    hits = sp.csr_matrix(
        (np.ones(len(ids), np.float32), (prot, ids)), shape=(len(lens), len(vocab))
    )
    sums = np.asarray(hits @ ngram_embeddings.astype(np.float32), dtype=np.float32)
    out: Dict[str, np.ndarray] = {}
    for p_idx, (pid, _) in enumerate(protein_sequences):
        if counts[p_idx] > 0:
            out[pid] = (sums[p_idx] / counts[p_idx]).astype(ngram_embeddings.dtype)
    return out
