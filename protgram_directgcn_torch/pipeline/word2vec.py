"""Residue-level skip-gram embedder (the Word2Vec baseline).

Port of protgram_directgcn_tpu/pipeline/word2vec.py:30-335 (reference:
src/pipeline/word2vec_embedder.py:31-160): skip-gram with negative sampling
over the per-residue FASTA corpus, gensim's schedule (linear lr decay,
dynamic windows, frequent-token subsampling), per-protein pooling, the
embeddings file and its PCA.

The host draws are the JAX package's, call for call, from one
``default_rng(seed)``: each sequence's subsampling mask and window sizes
(``_block_pairs``), each block's permutation and the unigram^0.75
negatives, so the pair and negative streams are identical.  A block's
negatives are drawn in one call (the same numbers as one call a batch),
and the block goes to the device once.  The SGD step runs there: row
gathers of the two ``[V, D]`` tables, the ``bd,bkd->bk`` product, the
gradients written out by hand and summed into each table with
``index_add_``, and ``table -= lr * grad``; no step reads a value back (the
loss is read once an epoch, for the log).  The input table starts uniform
in ``±0.5 / dim`` from a host ``torch.Generator`` seeded by ``seed``, so
the card and the CPU start equal; the output table starts at zero.
"""

from __future__ import annotations

import os
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.utils import embeddings as emb_utils
from protgram_directgcn_torch.utils.device import resolve_device
from protgram_directgcn_torch.utils.io import ensure_dir, logger, parse_fasta, write_embeddings


class SkipGramModel:
    """Tiny-vocabulary skip-gram with negative sampling.  ``params`` holds
    the ``"in"`` and ``"out"`` tables ``[V, D]`` on the device; ``timing``
    the host seconds of the numpy draws and of the device work (uploads,
    launches and the waits for the card), and ``steps`` the SGD steps."""

    def __init__(self, vocab: List[str], dim: int, lr: float = 0.025, seed: int = 42,
                 min_alpha: float = 1e-4, device="cuda"):
        self.vocab = vocab
        self.token_to_id = {t: i for i, t in enumerate(vocab)}
        self.lr = float(lr)
        self.min_alpha = float(min_alpha)
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        v = len(vocab)
        self.params = {
            "in": (torch.rand(v, dim, generator=gen) * (1.0 / dim) - 0.5 / dim).to(self.device),
            "out": torch.zeros(v, dim, device=self.device),
        }
        self.steps = 0
        self.timing = {"sampling_seconds": 0.0, "device_seconds": 0.0}

    def _step(self, alpha: float, center: torch.Tensor, context: torch.Tensor,
              negatives: torch.Tensor, want_loss: bool) -> Optional[torch.Tensor]:
        """One SGD step on ``-mean(log σ(v_c·u_o) + Σ_k log σ(-v_c·u_k))``."""
        w_in, w_out = self.params["in"], self.params["out"]
        b, k = negatives.shape
        vc, uo, un = w_in[center], w_out[context], w_out[negatives]  # [B,D] [B,D] [B,K,D]
        s_pos = (vc * uo).sum(-1)
        s_neg = torch.einsum("bd,bkd->bk", vc, un)
        g_pos = -torch.sigmoid(-s_pos) / b  # dL/ds_pos
        g_neg = torch.sigmoid(s_neg) / b  # dL/ds_neg
        g_vc = g_pos[:, None] * uo + torch.einsum("bk,bkd->bd", g_neg, un)
        grad_in = torch.zeros_like(w_in).index_add_(0, center, g_vc)
        grad_out = torch.zeros_like(w_out).index_add_(0, context, g_pos[:, None] * vc)
        grad_out.index_add_(0, negatives.reshape(-1),
                            (g_neg[:, :, None] * vc[:, None, :]).reshape(b * k, -1))
        w_in.sub_(alpha * grad_in)
        w_out.sub_(alpha * grad_out)
        self.steps += 1
        if want_loss:
            return -(F.logsigmoid(s_pos) + F.logsigmoid(-s_neg).sum(-1)).mean()
        return None

    @staticmethod
    def _block_pairs(ids: np.ndarray, window: int, rng: np.random.Generator):
        """Skip-gram pairs of one (already subsampled) sequence under a
        per-center dynamic window b_i ~ U{1..window} (gensim's reduced
        window)."""
        L = len(ids)
        if L < 2:
            return None
        b = rng.integers(1, window + 1, L)
        cs, xs = [], []
        for off in range(1, min(window, L - 1) + 1):
            keep_f = b[: L - off] >= off  # center on the left
            keep_b = b[off:] >= off  # center on the right
            cs.append(ids[: L - off][keep_f])
            xs.append(ids[off:][keep_f])
            cs.append(ids[off:][keep_b])
            xs.append(ids[: L - off][keep_b])
        return np.concatenate(cs), np.concatenate(xs)

    def train(self, corpus_ids, window: int, negative: int, epochs: int, batch_size: int,
              counts: np.ndarray, seed: int = 42, sample: float = 1e-3,
              block_pairs: int = 1 << 20) -> float:
        """Stream epochs of subsampled, dynamic-window skip-gram pairs;
        ``corpus_ids`` is a list of per-sequence id arrays or a zero-argument
        callable returning a fresh iterator of them.  Returns the last
        step's loss (NaN when no step ran)."""
        corpus_iter = corpus_ids if callable(corpus_ids) else (lambda: iter(corpus_ids))
        counts = np.asarray(counts, np.float64)
        freq = counts / max(1.0, counts.sum())
        if sample and sample > 0:
            ratio = sample / np.maximum(freq, 1e-12)  # keep: min(1, sqrt(s/f) + s/f)
            keep_prob = np.minimum(1.0, np.sqrt(ratio) + ratio)
        else:
            keep_prob = np.ones(len(counts))
        # Planned updates of the linear decay: expected kept tokens x the
        # expected window (mean (window + 1) / 2, both sides).
        kept_total = sum(float(keep_prob[ids].sum()) for ids in corpus_iter() if len(ids))
        planned_pairs = max(1.0, epochs * kept_total * (window + 1))
        p = counts ** 0.75
        p /= p.sum()
        rng = np.random.default_rng(seed)
        last_loss: Optional[torch.Tensor] = None
        processed = 0.0
        timing = self.timing

        def flush(buf_c, buf_x):
            nonlocal last_loss, processed
            t0 = time.monotonic()
            cs = np.concatenate(buf_c)
            xs = np.concatenate(buf_x)
            perm = rng.permutation(len(cs))
            n_batches = len(perm) // batch_size
            n_full = n_batches * batch_size
            if n_batches:
                negs = rng.choice(len(self.vocab), size=(n_full, negative), p=p)
            t1 = time.monotonic()
            timing["sampling_seconds"] += t1 - t0
            if n_batches:
                dev = self.device
                c_dev = torch.from_numpy(cs[perm[:n_full]]).to(dev, torch.int64)
                x_dev = torch.from_numpy(xs[perm[:n_full]]).to(dev, torch.int64)
                n_dev = torch.from_numpy(negs).to(dev)
                for i in range(n_batches):
                    alpha = max(self.min_alpha, self.lr * (1.0 - processed / planned_pairs))
                    sl = slice(i * batch_size, (i + 1) * batch_size)
                    loss = self._step(float(np.float32(alpha)), c_dev[sl], x_dev[sl], n_dev[sl],
                                      want_loss=i == n_batches - 1)
                    processed += batch_size
                last_loss = loss
            timing["device_seconds"] += time.monotonic() - t1
            tail = len(perm) % batch_size
            return ([cs[perm[-tail:]]], [xs[perm[-tail:]]]) if tail else ([], [])

        for epoch in range(epochs):
            buf_c, buf_x, buffered = [], [], 0
            t0 = time.monotonic()
            for ids in corpus_iter():
                if len(ids) < 2:
                    continue
                kept = ids[rng.random(len(ids)) < keep_prob[ids]]
                pairs = self._block_pairs(kept, window, rng)
                if pairs is None:
                    continue
                buf_c.append(pairs[0])
                buf_x.append(pairs[1])
                buffered += len(pairs[0])
                if buffered >= block_pairs:
                    timing["sampling_seconds"] += time.monotonic() - t0
                    buf_c, buf_x = flush(buf_c, buf_x)
                    t0 = time.monotonic()
                    buffered = sum(len(c) for c in buf_c)
            timing["sampling_seconds"] += time.monotonic() - t0
            if buffered:
                flush(buf_c, buf_x)  # the epoch's leftover tail is dropped
            t0 = time.monotonic()
            loss_val = float(last_loss) if last_loss is not None else float("nan")
            timing["device_seconds"] += time.monotonic() - t0
            logger.info("skip-gram epoch %d/%d loss %.4f (alpha %.5f)", epoch + 1, epochs,
                        loss_val, max(self.min_alpha, self.lr * (1.0 - processed / planned_pairs)))
        return float(last_loss) if last_loss is not None else float("nan")

    def vectors(self) -> np.ndarray:
        return self.params["in"].cpu().numpy()

    def save(self, path: os.PathLike):
        np.savez_compressed(path, vocab=np.array(self.vocab), vectors=self.vectors())

    def save_word2vec_format(self, path: os.PathLike, binary: bool = True):
        """The word2vec C format, byte for byte as gensim's
        ``_save_word2vec_format`` writes it: the header ``"<vocab> <dim>\\n"``,
        then per token ``b"<token> "`` and ``dim`` little-endian float32s with
        no separator (binary), or ``"<token> v1 v2 ...\\n"`` with ``repr``
        floats (text)."""
        vecs = self.vectors().astype(np.float32)
        with open(path, "wb") as f:
            f.write(f"{len(self.vocab)} {vecs.shape[1]}\n".encode("utf8"))
            for token, row in zip(self.vocab, vecs):
                if binary:
                    f.write(token.encode("utf8") + b" ")
                    f.write(row.astype("<f4").tobytes())
                else:
                    f.write((token + " " + " ".join(repr(float(v)) for v in row) + "\n")
                            .encode("utf8"))

    @classmethod
    def _with_vectors(cls, vocab: List[str], rows: np.ndarray, device) -> "SkipGramModel":
        model = cls(vocab, rows.shape[1], device=device)
        model.params["in"] = torch.from_numpy(np.array(rows, np.float32)).to(model.device)
        return model

    @classmethod
    def load_word2vec_format(cls, path: os.PathLike, binary: bool = True,
                             device="cuda") -> "SkipGramModel":
        """Read the word2vec C format back (gensim's loader: a token is the
        bytes up to a space, leading newlines skipped, so word2vec.c files
        with a newline after each row parse too)."""
        with open(path, "rb") as f:
            n_vocab, dim = (int(v) for v in f.readline().split())
            vocab, rows = [], np.empty((n_vocab, dim), dtype=np.float32)
            for i in range(n_vocab):
                word = b""
                while True:
                    ch = f.read(1)
                    if not ch:
                        raise ValueError(f"truncated word2vec file at token {i}")
                    if ch == b" ":
                        break
                    if ch != b"\n":
                        word += ch
                if binary:
                    rows[i] = np.frombuffer(f.read(dim * 4), dtype="<f4")
                else:
                    parts = (word + b" " + f.readline()).split()
                    word = parts[0]
                    rows[i] = [float(v) for v in parts[1:]]
                vocab.append(word.decode("utf8"))
        return cls._with_vectors(vocab, rows, device)

    @classmethod
    def load(cls, path: os.PathLike, device="cuda") -> "SkipGramModel":
        with np.load(path, allow_pickle=False) as z:
            vocab = [str(t) for t in z["vocab"]]
            vectors = z["vectors"]
        return cls._with_vectors(vocab, vectors, device)


def _token_ids(seq: str, lut: np.ndarray, tok: Dict[str, int]) -> np.ndarray:
    """The vocabulary ids of a sequence's residues, unknown ones dropped:
    ``[tok[c] for c in seq if c in tok]`` through a byte lookup table."""
    if not seq.isascii():
        return np.array([tok[c] for c in seq if c in tok], dtype=np.int32)
    ids = lut[np.frombuffer(seq.encode("ascii"), np.uint8)]
    return ids[ids >= 0]


class Word2VecEmbedder:
    """``run``: residue skip-gram, then the per-protein pooled embeddings
    file (+PCA).  ``stats`` keeps the run's counts, times and files."""

    def __init__(self, config: Optional[Config] = None, device="cuda"):
        self.config = config or Config()
        self.device = resolve_device(device)
        self.model: Optional[SkipGramModel] = None
        self.stats: Dict[str, object] = {}

    def run(self, fasta_path: Optional[os.PathLike] = None,
            output_dir: Optional[os.PathLike] = None) -> Optional[str]:
        """Train, then write ``word2vec_model_dim{D}.npz``, its
        ``.vectors.bin``, ``word2vec_dim{D}_{pooling}`` and, under
        ``word2vec.apply_pca``, its PCA (``.h5``, or ``.npz`` where h5py is
        absent); returns the path of the pooled embeddings file."""
        cfg = self.config
        w2v = cfg.word2vec
        fasta_path = fasta_path or cfg.paths.input_fasta
        output_dir = ensure_dir(output_dir or cfg.paths.word2vec_embeddings_dir)
        t0 = time.monotonic()

        counter: Counter = Counter()
        n_seqs = 0
        for _, seq in parse_fasta(fasta_path):
            counter.update(seq)
            n_seqs += 1
        if n_seqs == 0:
            logger.error("no sequences for word2vec at %s", fasta_path)
            return None
        vocab = sorted(t for t, c in counter.items() if c >= w2v.min_count)
        counts = np.array([counter[t] for t in vocab], dtype=np.int64)
        logger.info("skip-gram vocab: %d residue symbols (%d sequences)", len(vocab), n_seqs)

        model = SkipGramModel(vocab, w2v.vector_size, lr=w2v.lr, seed=cfg.random_state,
                              min_alpha=w2v.min_alpha, device=self.device)
        self.model = model
        tok = model.token_to_id
        lut = np.full(256, -1, np.int32)
        for t, i in tok.items():
            if len(t) == 1 and ord(t) < 128:
                lut[ord(t)] = i

        def corpus_stream():
            for _, seq in parse_fasta(fasta_path):
                yield _token_ids(seq, lut, tok)

        t_train = time.monotonic()
        final_loss = model.train(corpus_stream, w2v.window, w2v.negative, w2v.epochs,
                                 w2v.batch_size, counts, seed=cfg.random_state, sample=w2v.sample)
        train_seconds = time.monotonic() - t_train
        model_path = os.path.join(str(output_dir), f"word2vec_model_dim{w2v.vector_size}.npz")
        model.save(model_path)
        kv_path = os.path.join(str(output_dir),
                               f"word2vec_model_dim{w2v.vector_size}.vectors.bin")
        model.save_word2vec_format(kv_path, binary=True)
        logger.info("skip-gram model saved to %s (+ gensim-format %s) (%.1fs)",
                    model_path, kv_path, time.monotonic() - t0)

        # The GCN stage's id map, where it wrote one (word2vec_embedder.py:54-61).
        id_map: Dict[str, str] = {}
        map_file = cfg.paths.id_mapping_output_file
        if cfg.id_mapping_mode != "none" and os.path.exists(str(map_file)):
            with open(map_file) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) == 2:
                        id_map[parts[0]] = parts[1]

        t_pool = time.monotonic()
        vectors = model.vectors()
        protein_embeddings: Dict[str, np.ndarray] = {}
        for pid, seq in parse_fasta(fasta_path):
            ids = _token_ids(seq, lut, tok)
            if len(ids) == 0:
                continue
            pooled = emb_utils.pool_residue_embeddings(vectors[ids], w2v.pooling_strategy,
                                                       w2v.vector_size)
            protein_embeddings[id_map.get(pid, pid)] = pooled.astype(np.float16)
        emb_path = write_embeddings(
            os.path.join(str(output_dir), f"word2vec_dim{w2v.vector_size}_{w2v.pooling_strategy}.h5"),
            protein_embeddings)
        logger.info("word2vec embeddings saved: %s (%d proteins)", emb_path,
                    len(protein_embeddings))
        files = [model_path, kv_path, emb_path]
        if w2v.apply_pca and protein_embeddings:
            pca = emb_utils.apply_pca(protein_embeddings, cfg.gcn.pca_target_dim, cfg.random_state)
            if pca:
                dim = next(iter(pca.values())).shape[0]
                files.append(write_embeddings(os.path.join(
                    str(output_dir),
                    f"word2vec_dim{w2v.vector_size}_{w2v.pooling_strategy}_pca{dim}.h5"), pca))
                logger.info("word2vec PCA embeddings saved: %s", files[-1])
        self.stats = {"vocab": len(vocab), "sequences": n_seqs, "steps": model.steps,
                      "final_loss": final_loss, "train_seconds": train_seconds,
                      **model.timing, "pool_export_seconds": time.monotonic() - t_pool,
                      "files": files, "seconds": time.monotonic() - t0}
        return emb_path
