"""Port parity: the skip-gram Word2Vec baseline (``pipeline/word2vec.py``).

- ``_block_pairs`` equal to the JAX package's for the same generator.
- The streams a training run feeds its steps (learning rate, centers,
  contexts, negatives, step by step) equal to the JAX package's: the same
  numpy draws, call for call, though the port draws a block's negatives in
  one call.
- One and two epochs from the JAX package's initial tables (carried over by
  ``convert.skipgram_params_from_jax``): both tables at rtol 1e-5 (atol
  1e-7), and the last loss at rtol 1e-5.
- The binary ``.vectors.bin`` byte-equal to the JAX package's and to
  ``tests/data/gensim_golden.vectors.bin``; the binary, text and ``.npz``
  round trips.
- ``Word2VecEmbedder.run`` on a seeded FASTA against the JAX package's
  (vocabulary and counts, the vectors at rtol 1e-5, the pooled embeddings
  within one float16 ulp, the same files), the port starting from the JAX
  initial tables.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.config import Config as TConfig
from protgram_directgcn_torch.pipeline import word2vec as t_w2v
from protgram_directgcn_torch.utils import io as t_io
from protgram_directgcn_tpu.config import Config as JConfig
from protgram_directgcn_tpu.pipeline import word2vec as j_w2v
from protgram_directgcn_tpu.utils import io as j_io
from tests.test_torch_graph import write_seeded_fasta

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "gensim_golden.vectors.bin")


def _corpus(seed=0, n=25, v=7):
    rng = np.random.default_rng(seed)
    corpus = [rng.integers(0, v, int(rng.integers(0, 40))).astype(np.int32) for _ in range(n)]
    counts = np.bincount(np.concatenate(corpus), minlength=v)
    return corpus, counts


def _models(vocab, dim, seed=42):
    jm = j_w2v.SkipGramModel(vocab, dim, lr=0.05, seed=seed)
    tm = t_w2v.SkipGramModel(vocab, dim, lr=0.05, seed=seed, device="cpu")
    tm.params = convert.skipgram_params_from_jax(jm.params, device="cpu")
    return jm, tm


@pytest.mark.parametrize("length", [0, 1, 2, 3, 9, 40])
@pytest.mark.parametrize("window", [1, 5])
def test_block_pairs_match_jax(length, window):
    ids = np.arange(length, dtype=np.int32) * 3
    got = t_w2v.SkipGramModel._block_pairs(ids, window, np.random.default_rng(length))
    want = j_w2v.SkipGramModel._block_pairs(ids, window, np.random.default_rng(length))
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _record_jax(model, calls):
    def step(params, alpha, c, x, n):
        calls.append((float(alpha), np.asarray(c), np.asarray(x), np.asarray(n)))
        return params, jnp.float32(0.0)

    model._step = step


def _record_port(model, calls):
    def step(alpha, c, x, n, want_loss):
        calls.append((alpha, c.numpy(), x.numpy(), n.numpy()))
        return torch.zeros(()) if want_loss else None

    model._step = step


@pytest.mark.parametrize("sample", [0.0, 1e-2])
@pytest.mark.parametrize("block_pairs", [1 << 20, 64])
def test_pair_and_negative_streams_match_jax(sample, block_pairs):
    corpus, counts = _corpus(1)
    vocab = [chr(65 + i) for i in range(len(counts))]
    jm, tm = _models(vocab, 4)
    j_calls, t_calls = [], []
    _record_jax(jm, j_calls)
    _record_port(tm, t_calls)
    kw = dict(window=3, negative=4, epochs=2, batch_size=16, counts=counts, seed=5,
              sample=sample, block_pairs=block_pairs)
    jm.train(corpus, **kw)
    tm.train(corpus, **kw)
    assert len(t_calls) == len(j_calls) > 4
    for (ta, tc, tx, tn), (ja, jc, jx, jn) in zip(t_calls, j_calls):
        assert np.float32(ta) == np.float32(ja)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tn, jn)


@pytest.mark.parametrize("epochs", [1, 2])
def test_epochs_match_jax(epochs):
    corpus, counts = _corpus(2, n=40)
    vocab = [chr(65 + i) for i in range(len(counts))]
    jm, tm = _models(vocab, 8)
    kw = dict(window=3, negative=3, epochs=epochs, batch_size=32, counts=counts, seed=3,
              sample=1e-2, block_pairs=200)
    want = jm.train(corpus, **kw)
    got = tm.train(corpus, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tm.steps > 10
    for name in ("in", "out"):
        np.testing.assert_allclose(tm.params[name].numpy(), np.asarray(jm.params[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_own_init():
    a = t_w2v.SkipGramModel(list("ABC"), 10, seed=4, device="cpu")
    b = t_w2v.SkipGramModel(list("ABC"), 10, seed=4, device="cpu")
    assert torch.equal(a.params["in"], b.params["in"])
    assert a.params["in"].abs().max() <= 0.05 and not a.params["out"].any()
    assert np.isnan(a.train([np.zeros(1, np.int32)], 2, 2, 1, 8, np.ones(3)))


def test_binary_writer_byte_equal_and_golden(tmp_path):
    vocab = ["the", "of", "and"]
    vecs = np.array([[0.5, -1.25, 2.0], [0.1, 0.2, -0.3], [1e-3, -7.5, 42.0]], np.float32)
    tm = t_w2v.SkipGramModel(vocab, 3, device="cpu")
    tm.params["in"] = torch.from_numpy(vecs)
    jm = j_w2v.SkipGramModel(vocab, 3)
    jm.params = {"in": jnp.asarray(vecs), "out": jm.params["out"]}
    for binary in (True, False):
        tm.save_word2vec_format(tmp_path / "t.bin", binary=binary)
        jm.save_word2vec_format(tmp_path / "j.bin", binary=binary)
        assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
        back = t_w2v.SkipGramModel.load_word2vec_format(tmp_path / "t.bin", binary=binary,
                                                        device="cpu")
        assert back.vocab == vocab
        np.testing.assert_array_equal(back.vectors(), vecs)
    tm.save_word2vec_format(tmp_path / "g.bin", binary=True)
    with open(GOLDEN, "rb") as f:
        assert (tmp_path / "g.bin").read_bytes() == f.read()
    golden = t_w2v.SkipGramModel.load_word2vec_format(GOLDEN, device="cpu")
    assert golden.vocab == vocab
    np.testing.assert_array_equal(golden.vectors(), vecs)
    with open(tmp_path / "c.bin", "wb") as f:  # word2vec.c: a newline after each row
        f.write(b"3 3\n")
        for w, row in zip(vocab, vecs):
            f.write(w.encode() + b" " + row.astype("<f4").tobytes() + b"\n")
    np.testing.assert_array_equal(
        t_w2v.SkipGramModel.load_word2vec_format(tmp_path / "c.bin", device="cpu").vectors(), vecs)
    tm.save(tmp_path / "m.npz")
    for loaded in (t_w2v.SkipGramModel.load(tmp_path / "m.npz", device="cpu"),
                   j_w2v.SkipGramModel.load(tmp_path / "m.npz")):
        assert loaded.vocab == vocab
        np.testing.assert_array_equal(np.asarray(loaded.vectors()), vecs)
    with open(tmp_path / "cut.bin", "wb") as f:
        f.write(b"2 3\nab")
    with pytest.raises(ValueError, match="truncated"):
        t_w2v.SkipGramModel.load_word2vec_format(tmp_path / "cut.bin", device="cpu")


def test_embedder_run_matches_jax(tmp_path, monkeypatch):
    fasta = write_seeded_fasta(tmp_path / "seq.fasta", n_seqs=40, lo=30, hi=90)
    with open(fasta, "a") as f:  # a residue outside the 20, and a non-ASCII one
        f.write(">sp|Q99999|ODD\nMKXXAÄC\n")
    configs = []
    for cls, sub in ((JConfig, "j"), (TConfig, "t")):
        cfg = cls()
        cfg.paths.base_output_dir = tmp_path / sub
        cfg.word2vec.vector_size = 12
        cfg.word2vec.epochs = 2
        cfg.word2vec.batch_size = 128
        cfg.gcn.pca_target_dim = 6
        configs.append(cfg)

    class FromJax(t_w2v.SkipGramModel):
        def __init__(self, vocab, dim, lr=0.025, seed=42, min_alpha=1e-4, device="cuda"):
            super().__init__(vocab, dim, lr, seed, min_alpha, device)
            self.params = convert.skipgram_params_from_jax(
                j_w2v.SkipGramModel(vocab, dim, lr, seed, min_alpha).params, device=self.device)

    monkeypatch.setattr(t_w2v, "SkipGramModel", FromJax)
    j_path = j_w2v.Word2VecEmbedder(configs[0]).run(fasta)
    emb = t_w2v.Word2VecEmbedder(configs[1], device="cpu")
    t_path = emb.run(fasta)
    assert os.path.basename(t_path) == os.path.basename(j_path) == "word2vec_dim12_mean.h5"
    jm = j_w2v.SkipGramModel.load(tmp_path / "j" / "2_word2vec_embeddings" / "word2vec_model_dim12.npz")
    assert emb.model.vocab == jm.vocab and "Ä" in jm.vocab and "X" in jm.vocab
    np.testing.assert_allclose(emb.model.vectors(), jm.vectors(), rtol=1e-5, atol=1e-7)
    assert emb.stats["steps"] == emb.model.steps > 0 and np.isfinite(emb.stats["final_loss"])
    with j_io.EmbeddingStore(j_path) as js, t_io.EmbeddingStore(t_path) as ts:
        assert ts.get_keys() == js.get_keys() and len(ts) == 41
        for k in js.get_keys():
            np.testing.assert_allclose(ts[k].astype(np.float32), js[k].astype(np.float32),
                                       rtol=1e-3, atol=1e-6)
    names = sorted(os.listdir(tmp_path / "j" / "2_word2vec_embeddings"))
    assert sorted(os.listdir(tmp_path / "t" / "2_word2vec_embeddings")) == names
    assert "word2vec_dim12_mean_pca6.h5" in names and "word2vec_model_dim12.vectors.bin" in names
