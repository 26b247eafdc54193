"""Port parity: n-gram graph ETL, the 𝒜 matrices, labels and pooling.

The port's graph layer (protgram_directgcn_torch.graph, .pipeline.labels,
.utils.embeddings) against the JAX package's on the same FASTA input.
Graph arrays and 𝒜 matrices must be byte-exact (same numpy arithmetic);
pooling adds in another order (one sparse product), so it is held at
rtol 1e-5 / atol 1e-7 in float32.
"""

import numpy as np
import pytest

from protgram_directgcn_torch.graph import builder as t_builder
from protgram_directgcn_torch.graph import structure as t_structure
from protgram_directgcn_torch.graph import transforms as t_transforms
from protgram_directgcn_torch.pipeline import labels as t_labels
from protgram_directgcn_torch.utils import embeddings as t_emb
from protgram_directgcn_torch.utils import io as t_io
from protgram_directgcn_tpu.graph import structure as j_structure
from protgram_directgcn_tpu.graph import transforms as j_transforms
from protgram_directgcn_tpu.graph.builder import NgramGraphBuilder as JBuilder
from protgram_directgcn_tpu.pipeline import labels as j_labels
from protgram_directgcn_tpu.utils import embeddings as j_emb
from protgram_directgcn_tpu.utils import io as j_io

_AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)


def write_seeded_fasta(path, n_seqs=60, seed=3, lo=5, hi=70):
    """Seeded FASTA over the 20 standard amino acids, ``sp|ID|...`` headers."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n_seqs):
            seq = _AA[rng.integers(0, 20, int(rng.integers(lo, hi + 1)))].tobytes().decode()
            f.write(f">sp|Q{i:05d}|SYN{i}_TEST\n")
            for j in range(0, len(seq), 60):
                f.write(seq[j : j + 60] + "\n")
    return path


@pytest.fixture(params=["toy", "seeded"])
def fasta(request, toy_fasta, tmp_path):
    if request.param == "toy":
        return toy_fasta
    return write_seeded_fasta(tmp_path / "seeded.fasta")


def _both_graphs(fasta_path, n_max=3):
    seqs_j = list(j_io.parse_fasta(fasta_path))
    seqs_t = list(t_io.parse_fasta(fasta_path))
    assert seqs_j == seqs_t
    jg = JBuilder(n_max=n_max).build_from_sequences(seqs_j)
    tg = t_builder.NgramGraphBuilder(n_max=n_max).build_from_sequences(seqs_t)
    return jg, tg


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("level", [1, 2, 3])
def test_graph_arrays_byte_exact(fasta, level):
    jg, tg = _both_graphs(fasta)
    j, t = jg[level - 1], tg[level - 1]
    assert t.n == j.n == level
    for name in ("vocab", "src", "tgt", "weight"):
        _same_bytes(getattr(t, name), getattr(j, name))


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("matrix", ["mathcal_a_in", "mathcal_a_out", "undirected_norm"])
def test_propagation_matrices_byte_exact(fasta, level, matrix):
    jg, tg = _both_graphs(fasta)
    jm = j_transforms.csr_to_coo_arrays(getattr(jg[level - 1], matrix)())
    tm = t_transforms.csr_to_coo_arrays(getattr(tg[level - 1], matrix)())
    for a, b in zip(tm, jm):
        _same_bytes(a, b)


def test_npz_format_shared_both_ways(toy_fasta, tmp_path):
    jg, tg = _both_graphs(toy_fasta)
    for g_t, g_j in zip(tg, jg):
        p_t = tmp_path / f"port_n{g_t.n}.npz"
        p_j = tmp_path / f"jax_n{g_j.n}.npz"
        t_structure.save_graph(g_t, p_t)
        j_structure.save_graph(g_j, p_j)
        from_port = j_structure.load_graph(p_t)
        from_jax = t_structure.load_graph(p_j)
        for name in ("vocab", "src", "tgt", "weight"):
            _same_bytes(getattr(from_port, name), getattr(g_j, name))
            _same_bytes(getattr(from_jax, name), getattr(g_t, name))
        assert from_port.n == from_jax.n == g_t.n
        assert from_port.epsilon_propagation == from_jax.epsilon_propagation


def test_builder_run_writes_levels(toy_fasta, tmp_path):
    paths = t_builder.NgramGraphBuilder(n_max=3).run(toy_fasta, tmp_path / "graphs")
    assert [p.endswith(f"ngram_graph_n{n}.npz") for n, p in zip((1, 2, 3), paths)] == [True] * 3
    g3 = t_structure.load_graph(paths[2])
    assert g3.vocab[0] == " MK"  # boundary space on the first sequence only


@pytest.mark.parametrize("level", [1, 2, 3])
def test_next_node_labels_match(fasta, level):
    jg, tg = _both_graphs(fasta)
    yj, cj = j_labels.next_node_labels(jg[level - 1], seed=42)
    yt, ct = t_labels.next_node_labels(tg[level - 1], seed=42)
    assert ct == cj
    np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("k_hops", [0, 3])
def test_closest_aa_labels_match(fasta, level, k_hops):
    jg, tg = _both_graphs(fasta)
    yj, cj = j_labels.closest_aa_labels(jg[level - 1], k_hops, seed=7)
    yt, ct = t_labels.generate_labels(tg[level - 1], "closest_aa", k_hops, seed=7)
    assert ct == cj == k_hops + 1
    np.testing.assert_array_equal(yt, yj)


def test_unported_label_tasks_raise(toy_fasta):
    """The community task, which this test once found unported, now gives
    the JAX package's Louvain labels byte for byte at every level; an
    unknown task still raises."""
    jg, tg = _both_graphs(toy_fasta)
    for level in (1, 2, 3):
        yj, cj = j_labels.generate_labels(jg[level - 1], "community", seed=7)
        yt, ct = t_labels.generate_labels(tg[level - 1], "community", seed=7)
        assert ct == cj
        _same_bytes(yt, yj)
    with pytest.raises(ValueError, match="Unsupported task type"):
        t_labels.generate_labels(tg[1], "louvain")


@pytest.mark.parametrize("n_val", [1, 2, 3])
def test_pooling_matches(fasta, n_val):
    seqs = list(t_io.parse_fasta(fasta))
    _, tg = _both_graphs(fasta)
    vocab = tg[n_val - 1].vocab
    emb = np.random.default_rng(n_val).normal(size=(len(vocab), 6)).astype(np.float32)
    pj = j_emb.pool_ngram_embeddings_for_proteins(seqs, n_val, vocab, emb)
    pt = t_emb.pool_ngram_embeddings_for_proteins(seqs, n_val, vocab, emb)
    assert list(pt) == list(pj)
    for k in pj:
        assert pt[k].dtype == pj[k].dtype
        np.testing.assert_allclose(pt[k], pj[k], rtol=1e-5, atol=1e-7)


def test_pooling_drops_short_and_unknown(tmp_path):
    vocab = np.array(["AC", "CD"])
    emb = np.array([[1.0, 0.0], [0.0, 2.0]], np.float32)
    seqs = [("P1", "ACD"), ("P2", "A"), ("P3", "WWW"), ("P4", "CDAC")]
    pj = j_emb.pool_ngram_embeddings_for_proteins(seqs, 2, vocab, emb)
    pt = t_emb.pool_ngram_embeddings_for_proteins(seqs, 2, vocab, emb)
    assert list(pt) == list(pj) == ["P1", "P4"]
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], rtol=1e-6)


def test_regex_id_map_matches(fasta, tmp_path):
    assert t_io.generate_regex_id_map(fasta) == j_io.generate_regex_id_map(fasta)
