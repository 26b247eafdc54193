"""Port parity: the C++ n-gram ETL (``native.py``, ``csrc/ngram_etl.cpp``).

- each of the five entry points against the JAX package's ``native`` on the
  same seeded input, byte for byte;
- the graphs of the port's native path, its numpy path and the JAX
  package's builder byte for byte (vocabulary, edges, weights), over one
  shard and several (threads), and the path each level took recorded in
  ``NgramGraphBuilder.stats``;
- where the library cannot be built the builder falls back to numpy and
  says so in its stats.
"""

import numpy as np
import pytest

from protgram_directgcn_torch import native as t_native
from protgram_directgcn_torch.config import Config as TConfig
from protgram_directgcn_torch.graph.builder import NgramGraphBuilder as TBuilder
from protgram_directgcn_torch.utils.io import parse_fasta
from protgram_directgcn_tpu import native as j_native
from protgram_directgcn_tpu.graph.builder import NgramGraphBuilder as JBuilder
from tests.test_torch_graph import write_seeded_fasta


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _seqs(seed: int, count: int = 40):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b" ACDEFGHIKLMNPQRSTVWY", np.uint8)
    return [alphabet[rng.integers(0, 21, int(n))].tobytes()
            for n in rng.integers(0, 60, count)]


@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_pack_ngrams_batch(n):
    seqs = _seqs(n)
    for got, want in zip(t_native.pack_ngrams_batch(seqs, n), j_native.pack_ngrams_batch(seqs, n)):
        _same(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_emit_pairs_aggregate_merge_lookup(seed):
    rng = np.random.default_rng(seed)
    keys, counts = t_native.pack_ngrams_batch(_seqs(seed + 10), 3)
    vocab = np.unique(keys)
    ids_t = t_native.lookup_sorted(vocab, keys)
    _same(ids_t, j_native.lookup_sorted(vocab, keys))
    absent = rng.integers(0, 2**40, 50).astype(np.uint64)
    _same(t_native.lookup_sorted(vocab, absent), j_native.lookup_sorted(vocab, absent))
    nn = len(vocab)
    pairs = t_native.emit_pairs(ids_t, counts, nn)
    _same(pairs, j_native.emit_pairs(ids_t, counts, nn))
    agg_t, agg_j = t_native.aggregate_u64(pairs), j_native.aggregate_u64(pairs)
    for a, b in zip(agg_t, agg_j):
        _same(a, b)
    other = t_native.aggregate_u64(rng.integers(0, nn * nn, 500).astype(np.uint64))
    for a, b in zip(t_native.merge_aggregates(*agg_t, *other),
                    j_native.merge_aggregates(*agg_j, *other)):
        _same(a, b)
    for a, b in zip(t_native.aggregate_u64(np.empty(0, np.uint64)),
                    j_native.aggregate_u64(np.empty(0, np.uint64))):
        _same(a, b)


@pytest.mark.parametrize("shard_size,workers", [(1000, 1), (25, 1), (25, 4)])
def test_graphs_byte_equal_three_ways(tmp_path, shard_size, workers):
    fasta = write_seeded_fasta(tmp_path / "seq.fasta", n_seqs=120, lo=5, hi=150)
    seqs = list(parse_fasta(fasta))
    cfg = TConfig()
    cfg.graph_builder.workers = workers
    native = TBuilder(cfg, n_max=5, shard_size=shard_size)
    plain = TBuilder(cfg, n_max=5, shard_size=shard_size, use_native=False)
    graphs = [native.build_from_sequences(seqs), plain.build_from_sequences(seqs),
              JBuilder(n_max=5, shard_size=shard_size).build_from_sequences(seqs)]
    assert [native.stats[n]["etl"] for n in range(1, 6)] == ["native"] * 5
    assert [plain.stats[n]["etl"] for n in range(1, 6)] == ["numpy"] * 5
    for level in zip(*graphs):
        for field in ("vocab", "src", "tgt", "weight"):
            ref = getattr(level[2], field)
            for g in level[:2]:
                _same(getattr(g, field), ref)
        assert len({g.n for g in level}) == 1


def test_builder_falls_back_to_numpy_where_the_library_is_absent(monkeypatch):
    monkeypatch.setattr(t_native, "available", lambda: False)
    builder = TBuilder(n_max=2)
    graphs = builder.build_from_sequences([("P1", "MKTAYIAKQR"), ("P2", "GLIEV")])
    assert [builder.stats[n]["etl"] for n in (1, 2)] == ["numpy", "numpy"]
    assert builder.stats[2]["nodes"] == graphs[1].num_nodes
