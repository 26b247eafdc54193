"""Port parity: Louvain communities, the partitioners and the community task.

Three versions of Louvain on the same adjacency and seed: the JAX package's
``louvain_communities``, the port's with its numpy sweep (``sweep_plain``)
and the port's default, the C++ sweep (``csrc/louvain.cpp``, built here by
g++ as on the card's machine).  Labels must be byte-equal (same float64
arithmetic in the same order); ``modularity`` agrees within 1e-12.  The
partitioners and ``generate_labels(..., "community")`` are held byte for
byte against the JAX functions.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from protgram_directgcn_torch.graph import community as t_comm
from protgram_directgcn_torch.graph import partition as t_part
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder as TBuilder
from protgram_directgcn_torch.pipeline import labels as t_labels
from protgram_directgcn_torch.utils.io import parse_fasta
from protgram_directgcn_tpu.graph import community as j_comm
from protgram_directgcn_tpu.graph import partition as j_part
from protgram_directgcn_tpu.graph.builder import NgramGraphBuilder as JBuilder
from protgram_directgcn_tpu.pipeline import labels as j_labels
from tests.test_torch_graph import _same_bytes, write_seeded_fasta


def _random_graph(seed: int, n: int, e: int, weights: str):
    """A seeded directed weighted graph with self-loops; "int" weights in
    {1, 2, 3} give many equal gains, "float" weights few."""
    rng = np.random.default_rng(seed)
    src, tgt = rng.integers(0, n, e), rng.integers(0, n, e)
    loops = rng.choice(n, size=max(1, n // 10), replace=False)
    src, tgt = np.concatenate([src, loops]), np.concatenate([tgt, loops])
    if weights == "int":
        w = rng.integers(1, 4, len(src)).astype(np.float64)
    else:
        w = rng.random(len(src)) + 0.1
    return sp.coo_matrix((w, (src, tgt)), shape=(n, n)).tocsr()


def _disconnected(seed: int):
    """Two random components, a ring, self-loop-only nodes and isolated
    nodes."""
    a = _random_graph(seed, 40, 120, "int")
    b = _random_graph(seed + 1, 30, 60, "float")
    ring = sp.coo_matrix((np.ones(8), (np.arange(8), (np.arange(8) + 1) % 8)), shape=(8, 8))
    loops = sp.diags(np.full(3, 2.0))
    isolated = sp.csr_matrix((4, 4))
    return sp.block_diag([a, b, ring, loops, isolated]).tocsr()


def _toy_adjacency(level: int):
    """A_out + A_outᵀ of the toy FASTA's n-gram level, as community_labels
    builds it."""
    seqs = [("P001", "MKTAYIAKQR"), ("P002", "QDKTAYIAK"), ("P003", "MKTAYHRQD")]
    g = TBuilder(n_max=3).build_from_sequences(seqs)[level - 1]
    a = sp.coo_matrix((g.weight, (g.src, g.tgt)), shape=(g.num_nodes,) * 2).tocsr()
    return a + a.T


GRAPHS = {
    "int_weights": lambda: _random_graph(0, 60, 240, "int"),
    "float_weights": lambda: _random_graph(1, 150, 500, "float"),
    "sparse_ties": lambda: _random_graph(2, 200, 260, "int"),
    "dense_ties": lambda: _random_graph(3, 50, 1200, "int"),
    "disconnected": lambda: _disconnected(4),
    "few_thousand": lambda: _random_graph(5, 3000, 12000, "int"),
    "empty": lambda: sp.csr_matrix((0, 0)),
    "no_edges": lambda: sp.csr_matrix((7, 7)),
    "toy_n2": lambda: _toy_adjacency(2),
    "toy_n3": lambda: _toy_adjacency(3),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("seed", [0, 42])
def test_louvain_labels_byte_equal(name, seed):
    adj = GRAPHS[name]()
    want = j_comm.louvain_communities(adj, seed=seed)
    plain = t_comm.louvain_communities(adj, seed=seed, sweep=t_comm.sweep_plain)
    native = t_comm.louvain_communities(adj, seed=seed)
    _same_bytes(plain, want)
    _same_bytes(native, want)
    if adj.shape[0]:
        q_t, q_j = t_comm.modularity(adj, native), j_comm.modularity(adj, want)
        assert abs(q_t - q_j) <= 1e-12


def test_louvain_finds_planted_communities():
    """Four dense blocks joined by single edges come out as four
    communities, with a modularity well above zero."""
    blocks = [np.ones((10, 10)) - np.eye(10)] * 4
    adj = sp.block_diag(blocks).tolil()
    for b in range(3):
        adj[10 * b + 9, 10 * (b + 1)] = 1.0
    adj = adj.tocsr()
    labels = t_comm.louvain_communities(adj, seed=0)
    assert len(np.unique(labels)) == 4
    assert all(len(np.unique(labels[10 * b:10 * b + 10])) == 1 for b in range(4))
    assert t_comm.modularity(adj, labels) > 0.6


def test_native_sweep_matches_plain_sweep_state():
    """One sweep from the same state moves the same nodes and leaves the
    same community totals, bit for bit."""
    adj = _random_graph(6, 300, 1500, "float")
    w = ((adj + adj.T) / 2.0).tocsr()
    k = np.asarray(w.sum(axis=1)).ravel()
    perm = np.random.default_rng(1).permutation(w.shape[0])
    out = {}
    for name, sweep in (("plain", t_comm.sweep_plain), ("native", t_comm.sweep_native)):
        comm, tot = np.arange(w.shape[0], dtype=np.int64), k.copy()
        moved = sweep(w.indptr.astype(np.int64), w.indices.astype(np.int64), w.data, k,
                      w.diagonal(), comm, tot, w.sum(), perm)
        out[name] = (moved, comm, tot)
    assert out["plain"][0] == out["native"][0] > 0
    _same_bytes(out["native"][1], out["plain"][1])
    _same_bytes(out["native"][2], out["plain"][2])


def test_native_sweep_rejects_bad_input():
    w = _random_graph(7, 20, 60, "int")
    k = np.asarray(w.sum(axis=1)).ravel()
    args = [w.indptr.astype(np.int64), w.indices.astype(np.int64), w.data, k, w.diagonal(),
            np.arange(20, dtype=np.int64), k.copy(), w.sum()]
    with pytest.raises(ValueError, match="out of range"):
        t_comm.sweep_native(*args, np.arange(20) + 1)
    with pytest.raises(ValueError, match="comm"):
        bad = list(args)
        bad[5] = np.arange(20, dtype=np.int32)
        t_comm.sweep_native(*bad, np.arange(20))


@pytest.mark.parametrize("method", ["block", "bfs", "louvain"])
@pytest.mark.parametrize("parts", [1, 2, 5, 13])
@pytest.mark.parametrize("seed", [0, 3])
def test_partition_nodes_byte_equal(method, parts, seed):
    adj = _disconnected(seed) if seed else _random_graph(seed, 120, 400, "int")
    want = j_part.partition_nodes(adj, parts, method=method, seed=seed)
    got = t_part.partition_nodes(adj, parts, method=method, seed=seed)
    _same_bytes(got, want)
    assert t_part.edge_cut_fraction(adj, got) == j_part.edge_cut_fraction(adj, want)


def test_partition_nodes_rejects_unknown_method():
    with pytest.raises(ValueError, match="Unknown partition method"):
        t_part.partition_nodes(sp.csr_matrix((3, 3)), 2, method="metis")


@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("seed", [7, 42])
def test_community_labels_byte_equal(tmp_path, level, seed):
    seqs = list(parse_fasta(write_seeded_fasta(tmp_path / "seq.fasta", n_seqs=80, lo=20,
                                               hi=120)))
    jg = JBuilder(n_max=3).build_from_sequences(seqs)[level - 1]
    tg = TBuilder(n_max=3).build_from_sequences(seqs)[level - 1]
    yj, cj = j_labels.community_labels(jg, seed=seed)
    yt, ct = t_labels.generate_labels(tg, "community", seed=seed)
    assert ct == cj and ct == int(yt.max()) + 1
    _same_bytes(yt, yj)
