"""Port parity: the transformer stage (``pipeline/transformer.py``).

``extract_residue_embeddings`` against the JAX package's on every branch;
the offline residue-projection fallback's file against the JAX package's
``run()`` (the same seeded draws, so the float16 vectors are equal bit for
bit; both files H5 here); ``_embed_with_model`` with one stub tokenizer and
one tiny ``nn.Module`` returning ``last_hidden_state``, injected into both
packages' ``_load_model``: the pooled vectors equal bit for bit, with BERT
and T5 extraction; and ``--stages transformer,ppi --device cpu`` evaluates
the fallback set.
"""

import types

import numpy as np
import pytest
import torch

from protgram_directgcn_torch.__main__ import main as t_main
from protgram_directgcn_torch.config import Config as TConfig
from protgram_directgcn_torch.pipeline import transformer as t_tr
from protgram_directgcn_torch.utils.io import parse_fasta, read_embeddings
from protgram_directgcn_tpu.config import Config as JConfig
from protgram_directgcn_tpu.pipeline import transformer as j_tr
from tests.test_torch_graph import write_seeded_fasta
from tests.test_torch_ppi import _write_pairs


@pytest.mark.parametrize("rows,seq_len,is_t5", [
    (0, 5, False), (7, 0, False), (7, -1, True), (1, 3, False), (7, 3, False), (7, 9, False),
    (7, 3, True), (7, 9, True)])
def test_extract_residue_embeddings_matches_jax(rows, seq_len, is_t5):
    raw = np.arange(rows * 2, dtype=np.float32).reshape(rows, 2)
    np.testing.assert_array_equal(t_tr.extract_residue_embeddings(raw, seq_len, is_t5),
                                  j_tr.extract_residue_embeddings(raw, seq_len, is_t5))


def _configs(tmp_path, **tset):
    out = []
    for cls, tag in ((JConfig, "j"), (TConfig, "t")):
        cfg = cls()
        cfg.paths.base_output_dir = tmp_path / tag
        for k, v in tset.items():
            setattr(cfg.transformer, k, v)
        out.append(cfg)
    return out


def test_fallback_file_equals_jax(tmp_path):
    fasta = write_seeded_fasta(tmp_path / "s.fasta", n_seqs=25, lo=0, hi=40)
    with open(fasta, "a") as f:
        f.write(">sp|Q99999|RARE\nMUZOBXK*\n")
    jcfg, tcfg = _configs(tmp_path, models_to_run=[{"name": "Missing", "hf_id": "no/such"}])
    jpaths = j_tr.TransformerEmbedder(jcfg).run(fasta)
    emb = t_tr.TransformerEmbedder(tcfg, device="cpu")
    tpaths = emb.run(fasta)
    assert emb.fallback and len(jpaths) == len(tpaths) == 1
    j, t = read_embeddings(jpaths[0]), read_embeddings(tpaths[0])
    assert sorted(j) == sorted(t) and "Q99999" in t
    for k in j:
        assert t[k].dtype == np.float16 and t[k].shape == (64,)
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


class _Tokenizer:
    """Residues to ids (CLS 1 and SEP 2 around them for BERT, EOS 2 after
    them for T5), padded to the batch's longest, truncated at max_length."""

    def __init__(self, t5: bool):
        self.t5 = t5

    def __call__(self, texts, return_tensors, padding, truncation, max_length):
        rows = []
        for text in texts:
            ids = [3 + ord(c) - ord("A") for c in text.split()]
            ids = ids + [2] if self.t5 else [1] + ids + [2]
            rows.append(ids[:max_length])
        width = max(len(r) for r in rows)
        ids = torch.tensor([r + [0] * (width - len(r)) for r in rows])
        mask = torch.tensor([[1] * len(r) + [0] * (width - len(r)) for r in rows])
        return {"input_ids": ids, "attention_mask": mask}


class _Model(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = torch.nn.Embedding(40, 6)
        self.mix = torch.nn.Linear(6, 6)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(0)
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))

    def forward(self, input_ids, attention_mask):
        h = self.emb(input_ids)
        h = h + self.mix(h.cumsum(1)) * attention_mask[..., None]
        return types.SimpleNamespace(last_hidden_state=h)


@pytest.mark.parametrize("is_t5", [False, True], ids=["bert", "t5"])
def test_embed_with_model_matches_jax(tmp_path, monkeypatch, is_t5):
    fasta = write_seeded_fasta(tmp_path / "s.fasta", n_seqs=20, lo=3, hi=20)
    seqs = list(parse_fasta(fasta))
    model, tok = _Model().eval(), _Tokenizer(is_t5)
    for cls in (j_tr.TransformerEmbedder, t_tr.TransformerEmbedder):
        monkeypatch.setattr(cls, "_load_model", lambda self, hf_id: (tok, model))
    jcfg, tcfg = _configs(tmp_path, max_length=12, base_batch_size=3)
    jp = j_tr.TransformerEmbedder(jcfg)._embed_with_model("Stub", "x", is_t5, 2, seqs, tmp_path / "j")
    emb = t_tr.TransformerEmbedder(tcfg, device="cpu")
    tp = emb._embed_with_model("Stub", "x", is_t5, 2, seqs, tmp_path / "t")
    j, t = read_embeddings(jp), read_embeddings(tp)
    assert sorted(j) == sorted(t) and len(t) == 20 and emb.stats["Stub"]["proteins"] == 20
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert (tmp_path / "t" / "stub_mean_pca6.h5").exists()


def test_cli_transformer_then_ppi_on_cpu(tmp_path):
    fasta = write_seeded_fasta(tmp_path / "seq.fasta", n_seqs=30, lo=20, hi=60)
    rng = np.random.default_rng(0)
    ids = [f"Q{i:05d}" for i in range(30)]
    _write_pairs(tmp_path / "pos.csv", rng, 120, ids)
    _write_pairs(tmp_path / "neg.csv", rng, 240, ids)
    result = t_main([
        "--fasta", str(fasta), "--out", str(tmp_path / "out"),
        "--stages", "transformer,ppi", "--device", "cpu",
        "--set", "transformer.models_to_run=[{\"name\": \"ProtBERT\", \"hf_id\": \"no/such\"}]",
        "--set", f"paths.interactions_positive={tmp_path / 'pos.csv'}",
        "--set", f"paths.interactions_negative={tmp_path / 'neg.csv'}",
        "--set", "eval.epochs=2", "--set", "eval.n_folds=2",
        "--set", "eval.plot_training_history=false",
    ])
    assert result["transformer"].fallback
    assert [p.rsplit("/", 1)[-1] for p in result["transformer_paths"]] == [
        "residue_projection_mean.h5"]
    assert [r["embedding_name"] for r in result["ppi_results"]] == ["Transformer"]
    assert np.isfinite(result["ppi_results"][0]["test_auc"])
    assert set(result["seconds"]) == {"transformer", "ppi"}
