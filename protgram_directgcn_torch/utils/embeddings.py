"""Pooling of n-gram embeddings to proteins.

Port of protgram_directgcn_tpu/utils/embeddings.py:67
(reference: models_utils.py:209-262): each protein is the mean of the
embeddings of its in-vocabulary n-grams; proteins with none are dropped.
Vectorised over the whole corpus: n-grams are packed into uint64 keys (the
graph builder's order-preserving packing) and looked up in the packed
vocabulary; the per-protein sums are one sparse-dense product, so they are
added in another order than the JAX package's per-protein loop.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import scipy.sparse as sp


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
