"""Transformer protein-embedding baseline (ProtBERT/ProtT5-style inference).

Port of protgram_directgcn_tpu/pipeline/transformer.py:1-155 (reference:
src/pipeline/transformer_embedder.py:32-198): space-separated residue
tokenization with U/Z/O/B -> X, batched inference with max-length
truncation, residue-vector extraction (BERT drops CLS; T5 truncates),
pooling, PCA and the embeddings file (H5 where h5py imports, else
``.npz``: ``utils.io.write_embeddings``).

A model loads from local files only (``local_files_only=True``; the
``transformers`` import is guarded): no network is asked.  Where one loads,
it runs on the stage's device, each batch moved there (the JAX package runs
it on the CPU).  Where none loads and ``transformer.offline_fallback`` holds,
the stage writes the seeded residue-projection embeddings instead
(``_embed_residue_projection``: the JAX package's draws, so the same
vectors), which the ``ppi`` stage finds under ``2_transformer_embeddings/``.
"""

from __future__ import annotations

import os
import re
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.utils import embeddings as emb_utils
from protgram_directgcn_torch.utils.device import resolve_device
from protgram_directgcn_torch.utils.io import ensure_dir, logger, parse_fasta, write_embeddings

_RESIDUES = "ACDEFGHIKLMNPQRSTVWYX"


def extract_residue_embeddings(raw: np.ndarray, seq_len: int, is_t5: bool) -> np.ndarray:
    """BERT: drop CLS then take seq_len tokens; T5: truncate to seq_len
    (reference: models_utils.py:149-163)."""
    if seq_len <= 0 or raw.shape[0] == 0:
        return raw[:0]
    if is_t5:
        return raw[: min(raw.shape[0], seq_len)]
    if raw.shape[0] <= 1:
        return raw[:0]
    return raw[1: min(raw.shape[0], seq_len + 1)]


class TransformerEmbedder:
    """The ``transformer`` stage; ``stats`` holds, per model name, the
    proteins embedded and the seconds, and ``fallback`` whether the
    residue-projection file was written."""

    def __init__(self, config: Optional[Config] = None, device="cuda"):
        self.config = config or Config()
        self.device = resolve_device(device)
        self.stats: Dict[str, Dict[str, float]] = {}
        self.fallback = False

    def _load_model(self, hf_id: str):
        """(tokenizer, model in eval mode on the stage's device) from local
        files, or (None, None) with a warning."""
        try:
            from transformers import AutoModel, AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(hf_id, local_files_only=True)
            model = AutoModel.from_pretrained(hf_id, local_files_only=True)
            model.eval()
            return tokenizer, model.to(self.device)
        except Exception as e:
            logger.warning("transformer model %s unavailable locally (%s); skipping", hf_id, e)
            return None, None

    def _embed_with_model(self, name: str, hf_id: str, is_t5: bool, batch_mult: int,
                          sequences, output_dir) -> Optional[str]:
        tcfg = self.config.transformer
        tokenizer, model = self._load_model(hf_id)
        if model is None:
            return None
        batch_size = tcfg.base_batch_size * max(1, batch_mult)
        pooled: Dict[str, np.ndarray] = {}
        t0 = time.monotonic()
        with torch.no_grad():
            for i in range(0, len(sequences), batch_size):
                batch = sequences[i: i + batch_size]
                # Space-separated residues, rare residues mapped to X
                # (reference: transformer_embedder.py:91-92).
                texts = [" ".join(re.sub(r"[UZOB]", "X", seq)) for _, seq in batch]
                enc = tokenizer(texts, return_tensors="pt", padding=True, truncation=True,
                                max_length=tcfg.max_length)
                enc = {k: v.to(self.device) for k, v in enc.items()}
                out = model(**enc).last_hidden_state.float().cpu().numpy()
                mask = enc["attention_mask"].cpu().numpy()
                for j, (pid, seq) in enumerate(batch):
                    res = extract_residue_embeddings(out[j][mask[j] > 0], len(seq), is_t5)
                    if res.shape[0]:
                        pooled[pid] = emb_utils.pool_residue_embeddings(
                            res, tcfg.pooling_strategy).astype(np.float16)
        seconds = time.monotonic() - t0
        self.stats[name] = {"proteins": len(pooled), "seconds": seconds}
        logger.info("[%s] embedded %d proteins in %.1fs", name, len(pooled), seconds)
        if not pooled:
            return None
        path = write_embeddings(
            os.path.join(str(output_dir), f"{name.lower()}_{tcfg.pooling_strategy}.h5"), pooled)
        if tcfg.apply_pca:
            pca = emb_utils.apply_pca(pooled, self.config.gcn.pca_target_dim,
                                      self.config.random_state)
            if pca:
                dim = next(iter(pca.values())).shape[0]
                write_embeddings(os.path.join(
                    str(output_dir), f"{name.lower()}_{tcfg.pooling_strategy}_pca{dim}.h5"), pca)
        return path

    def run(self, fasta_path: Optional[os.PathLike] = None,
            output_dir: Optional[os.PathLike] = None) -> List[str]:
        """Embed every protein of the FASTA with each configured model, or
        with the fallback where none loads; returns the files written."""
        cfg = self.config
        fasta_path = fasta_path or cfg.paths.input_fasta
        output_dir = ensure_dir(output_dir or cfg.paths.transformer_embeddings_dir)
        sequences = list(parse_fasta(fasta_path))
        if not sequences:
            logger.error("no sequences for transformer embedding at %s", fasta_path)
            return []
        outputs = []
        for spec in cfg.transformer.models_to_run:
            path = self._embed_with_model(
                spec["name"], spec["hf_id"], spec.get("is_t5", False),
                spec.get("batch_size_multiplier", 1), sequences, output_dir)
            if path:
                outputs.append(path)
        if not outputs and cfg.transformer.offline_fallback:
            path = self._embed_residue_projection(sequences, output_dir)
            if path:
                outputs.append(path)
        return outputs

    def _embed_residue_projection(self, sequences, output_dir) -> Optional[str]:
        """Offline fallback: ``residue_projection_embeddings`` of the
        sequences, written as ``residue_projection_{pooling}``."""
        tcfg = self.config.transformer
        pooled = residue_projection_embeddings(sequences, tcfg.fallback_dim,
                                               self.config.random_state, tcfg.pooling_strategy)
        if not pooled:
            return None
        self.fallback = True
        logger.info("no transformer checkpoint available; wrote residue-projection fallback "
                    "embeddings for %d proteins (AA-composition baseline)", len(pooled))
        return write_embeddings(os.path.join(
            str(output_dir), f"residue_projection_{tcfg.pooling_strategy}.h5"), pooled)


def residue_projection_embeddings(sequences, dim: int, seed: int,
                                  pooling: str = "mean") -> Dict[str, np.ndarray]:
    """Seeded per-residue projection embeddings, float16: each residue type
    maps to a fixed Gaussian vector drawn from ``default_rng(seed)`` in the
    order of ``_RESIDUES`` (transformer.py:125-155 of the JAX package), and
    a protein's vectors are pooled, so mean pooling yields (smoothed)
    amino-acid-composition features, a sequence-only baseline that keeps
    the PPI comparison runnable without a checkpoint."""
    rng = np.random.default_rng(seed)
    table = np.stack([rng.standard_normal(dim).astype(np.float32) for _ in _RESIDUES])
    # A residue's row; any other character reads X's, as U/Z/O/B do.
    lut = np.full(256, _RESIDUES.index("X"), np.int64)
    lut[np.frombuffer(_RESIDUES.encode(), np.uint8)] = np.arange(len(_RESIDUES))
    pooled: Dict[str, np.ndarray] = {}
    for pid, seq in sequences:
        if seq:
            res = table[lut[np.frombuffer(seq.encode("ascii", "replace"), np.uint8)]]
            pooled[pid] = emb_utils.pool_residue_embeddings(res, pooling).astype(np.float16)
    return pooled
