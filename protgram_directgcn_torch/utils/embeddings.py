"""Pooling of n-gram embeddings to proteins, and their PCA.

Port of protgram_directgcn_tpu/utils/embeddings.py:23-55, 67
(reference: models_utils.py:87-136, 209-262).  Pooling: each protein is the
mean of the embeddings of its in-vocabulary n-grams; proteins with none are
dropped.
Vectorised over the whole corpus: n-grams are packed into uint64 keys (the
graph builder's order-preserving packing) and looked up in the packed
vocabulary; the per-protein sums are one sparse-dense product, so they are
added in another order than the JAX package's per-protein loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from protgram_directgcn_torch.utils.io import logger


def _is_constant_feature(var: torch.Tensor, mean: torch.Tensor, n: int) -> torch.Tensor:
    """sklearn's ``_is_constant_feature``: a variance within float64's
    rounding of zero."""
    eps = torch.finfo(torch.float64).eps
    return var <= n * eps * var + (n * mean * eps) ** 2


def apply_pca(embeddings: Dict[str, np.ndarray], target_dim: int,
              output_dtype=np.float16) -> Optional[Dict[str, np.ndarray]]:
    """StandardScaler then PCA to ``min(target_dim, dim, n_samples)``
    components, float16 output (utils/embeddings.py:23-55 of the JAX
    package, which calls sklearn).  In torch on the host, in float64: the
    columns centred and divided by their population std (a constant column
    by 1), then ``torch.linalg.svd``; each component's sign makes its
    largest-magnitude loading positive (sklearn 1.9's
    ``svd_flip(u_based_decision=False)``)."""
    items = [(k, v.astype(np.float32)) for k, v in embeddings.items()
             if v is not None and v.size > 0]
    if not items:
        logger.error("PCA: no valid embeddings provided")
        return None
    ids = [k for k, _ in items]
    mat = torch.from_numpy(np.stack([v for _, v in items])).double()
    n_samples, dim = mat.shape
    actual = min(target_dim, dim, n_samples)
    if actual <= 0:
        return {k: v.astype(output_dtype) for k, v in items}
    if actual < target_dim:
        logger.warning("PCA: adjusted target dim %d -> %d", target_dim, actual)
    mean = mat.mean(0)
    var = mat.var(0, correction=0)
    std = torch.where(_is_constant_feature(var, mean, n_samples), 1.0, var.sqrt())
    scaled = (mat - mean) / std
    centred = scaled - scaled.mean(0)
    _, s, vt = torch.linalg.svd(centred, full_matrices=False)
    rows = torch.arange(vt.shape[0])
    vt = vt * torch.sign(vt[rows, vt.abs().argmax(1)])[:, None]
    out = centred @ vt[:actual].T
    total = float((s ** 2).sum())
    explained = float((s[:actual] ** 2).sum()) / total if total else 0.0
    logger.info("PCA %s -> %s (explained variance %.4f)", tuple(mat.shape), tuple(out.shape),
                explained)
    out = out.numpy().astype(output_dtype)
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
