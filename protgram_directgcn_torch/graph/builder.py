"""N-gram transition graph ETL: the C++ kernels, or numpy.

Port of protgram_directgcn_tpu/graph/builder.py: n-grams packed into uint64
keys (big-endian bytes, so sorted keys == sorted strings == the reference's
sorted-id assignment, data_builder.py:164-172), a vocabulary merged from
per-shard unique keys, and edges between consecutive n-grams of each padded
sequence aggregated by sorting their packed (src, tgt) keys.  A leading
space on the first sequence and a trailing space on every sequence
(data_builder.py:29-35).

Under ``graph_builder.use_native`` (the default) each shard goes through the
C++ ETL (``native.py``, ``csrc/ngram_etl.cpp``) where the library builds,
else through numpy; both give the same graphs, byte for byte.  Shards are
packed by ``graph_builder.workers`` threads (ctypes releases the GIL).  The
path each level took and its seconds are kept in ``NgramGraphBuilder.stats``
and logged, so a fallback to numpy shows.

Output: one ``ngram_graph_n{n}.npz`` per level, in the JAX package's format.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.graph.structure import NgramGraph, save_graph
from protgram_directgcn_torch.utils.io import logger, parse_fasta

_MAX_PACK_N = 8  # uint64 fits 8 bytes


def _pack_ngrams(seq_bytes: np.ndarray, n: int) -> np.ndarray:
    """All n-gram windows of a byte sequence packed into uint64 keys."""
    if len(seq_bytes) < n:
        return np.empty(0, dtype=np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(seq_bytes, n)  # [L-n+1, n]
    keys = np.zeros(win.shape[0], dtype=np.uint64)
    for i in range(n):
        keys = (keys << np.uint64(8)) | win[:, i].astype(np.uint64)
    return keys


def _unpack_keys(keys: np.ndarray, n: int) -> np.ndarray:
    """uint64 keys back to an array of n-character strings."""
    out = np.empty((len(keys), n), dtype=np.uint8)
    for i in range(n):
        shift = np.uint64(8 * (n - 1 - i))
        out[:, i] = ((keys >> shift) & np.uint64(0xFF)).astype(np.uint8)
    return out.view(f"S{n}").ravel().astype(f"U{n}")


def preprocess_sequences(
    sequences: Iterable[Tuple[str, str]], add_boundary_spaces: bool = True
) -> Iterator[str]:
    """Leading space on the first sequence, trailing space on all
    (reference: data_builder.py:29-35)."""
    first = True
    for _, seq in sequences:
        text = str(seq)
        if add_boundary_spaces:
            if first:
                text = " " + text
            text = text + " "
        first = False
        yield text


class NgramGraphBuilder:
    """Builds ``NgramGraph`` objects for n = 1..n_max from FASTA input."""

    def __init__(self, config: Optional[Config] = None, n_max: Optional[int] = None,
                 epsilon: Optional[float] = None, add_boundary_spaces: Optional[bool] = None,
                 shard_size: Optional[int] = None, use_native: Optional[bool] = None):
        cfg = config or Config()
        gb = cfg.graph_builder
        self.config = cfg
        self.n_max = n_max if n_max is not None else gb.ngram_max_n
        self.epsilon = epsilon if epsilon is not None else gb.propagation_epsilon
        self.add_boundary_spaces = (
            add_boundary_spaces if add_boundary_spaces is not None else gb.add_boundary_spaces
        )
        self.shard_size = shard_size if shard_size is not None else gb.sequences_per_shard
        self.use_native = use_native if use_native is not None else gb.use_native
        self.workers = max(1, int(gb.workers))
        # Per level of the last build: {"etl": "native" | "numpy", "seconds",
        # "nodes", "edges"}.
        self.stats: Dict[int, dict] = {}
        if self.n_max > _MAX_PACK_N:
            raise ValueError(f"n_max {self.n_max} > {_MAX_PACK_N} not supported by uint64 packing")

    def build_from_sequences(self, sequences: Sequence[Tuple[str, str]]) -> List[NgramGraph]:
        """Build all levels in one pass over in-memory sequences."""
        processed = list(preprocess_sequences(sequences, self.add_boundary_spaces))
        seq_bytes = [np.frombuffer(s.encode("latin-1"), dtype=np.uint8) for s in processed]
        use_native = False
        if self.use_native:
            from protgram_directgcn_torch import native

            use_native = native.available()
        graphs = []
        self.stats = {}
        for n in range(1, self.n_max + 1):
            t0 = time.monotonic()
            graphs.append(self._build_level(seq_bytes, n, use_native))
            g = graphs[-1]
            self.stats[n] = {"etl": "native" if use_native else "numpy",
                             "seconds": time.monotonic() - t0, "nodes": g.num_nodes,
                             "edges": g.num_edges}
            logger.info("built n=%d graph (%s ETL): %d nodes, %d edges (%.2fs)",
                        n, self.stats[n]["etl"], g.num_nodes, g.num_edges,
                        self.stats[n]["seconds"])
        return graphs

    def _build_level(self, seq_bytes: List[np.ndarray], n: int,
                     use_native: bool = False) -> NgramGraph:
        """One level, shard by shard (builder.py:117-170 of the JAX package)."""
        if use_native:
            from protgram_directgcn_torch import native

        def pack_shard(shard):
            if use_native:
                keys, lens = native.pack_ngrams_batch(shard, n)
                return keys, lens, native.aggregate_u64(keys)[0]
            keys_list = [_pack_ngrams(b, n) for b in shard]
            lens = np.array([len(k) for k in keys_list], dtype=np.int64)
            keys = np.concatenate(keys_list) if keys_list else np.empty(0, np.uint64)
            return keys, lens, np.unique(keys)

        shards = [seq_bytes[s : s + self.shard_size]
                  for s in range(0, len(seq_bytes), self.shard_size)]
        if self.workers > 1 and len(shards) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                packed = list(pool.map(pack_shard, shards))  # in shard order
        else:
            packed = [pack_shard(s) for s in shards]

        vocab_keys = np.empty(0, dtype=np.uint64)
        per_shard: List[Tuple[np.ndarray, np.ndarray]] = []
        for keys, lens, shard_unique in packed:
            per_shard.append((keys, lens))
            vocab_keys = np.union1d(vocab_keys, shard_unique)

        num_nodes = len(vocab_keys)
        vocab = _unpack_keys(vocab_keys, n)

        # Edge aggregation: consecutive n-gram pairs within each sequence.
        agg_keys = np.empty(0, dtype=np.uint64)
        agg_counts = np.empty(0, dtype=np.int64)
        nn = np.uint64(max(num_nodes, 1))
        for keys, lens in per_shard:
            if use_native:
                if len(keys) == 0:
                    continue
                ids = native.lookup_sorted(vocab_keys, keys)
                pair_keys = native.emit_pairs(ids, lens, int(nn))
                if len(pair_keys) == 0:
                    continue
                uk, counts = native.aggregate_u64(pair_keys)
                agg_keys, agg_counts = native.merge_aggregates(agg_keys, agg_counts, uk, counts)
                continue
            if len(keys) < 2:
                continue
            ids = np.searchsorted(vocab_keys, keys).astype(np.uint64)
            # Pair positions: exclude the last window of each sequence.
            ends = np.cumsum(lens)
            valid = np.ones(len(ids), dtype=bool)
            valid[ends[lens > 0] - 1] = False
            pair_keys = (ids[:-1] * nn + ids[1:])[valid[:-1]]
            uk, counts = np.unique(pair_keys, return_counts=True)
            merged = np.concatenate([agg_keys, uk])
            merged_counts = np.concatenate([agg_counts, counts])
            order = np.argsort(merged, kind="stable")
            merged, merged_counts = merged[order], merged_counts[order]
            uniq, start_idx = np.unique(merged, return_index=True)
            summed = np.add.reduceat(merged_counts, start_idx) if len(merged) else merged_counts
            agg_keys, agg_counts = uniq, summed

        return NgramGraph(
            n=n,
            vocab=vocab,
            src=(agg_keys // nn).astype(np.int32),
            tgt=(agg_keys % nn).astype(np.int32),
            weight=agg_counts.astype(np.float32),
            epsilon_propagation=self.epsilon,
        )

    def run(self, fasta_path: Optional[os.PathLike] = None,
            output_dir: Optional[os.PathLike] = None) -> List[str]:
        """FASTA → per-level graph artifacts on disk
        (reference GraphBuilder.run contract, data_builder.py:70-341)."""
        fasta_path = fasta_path or self.config.paths.input_fasta
        output_dir = output_dir or self.config.paths.graph_objects_dir
        t0 = time.monotonic()
        sequences = list(parse_fasta(fasta_path))
        if not sequences:
            logger.error("No sequences found in %s", fasta_path)
            return []
        logger.info("loaded %d sequences from %s", len(sequences), fasta_path)
        graphs = self.build_from_sequences(sequences)
        os.makedirs(str(output_dir), exist_ok=True)
        paths = []
        for g in graphs:
            path = os.path.join(str(output_dir), f"ngram_graph_n{g.n}.npz")
            save_graph(g, path)
            paths.append(path)
            logger.info("saved n=%d: nodes=%d edges=%d -> %s", g.n, g.num_nodes, g.num_edges, path)
        logger.info("graph building finished in %.2fs", time.monotonic() - t0)
        return paths
