"""The traffic of a cell: a seeded FASTA corpus, the level's graph built from
it by the program's ETL, and the seeded inputs of a run.

A mix's file (``traffic/<mix>.json``) gives the corpus generator's
parameters and its data seed, the level ``n``, the input width and the
class count.  The corpus and the graph depend on the mix alone, so they are
built once, on a cell's first run in a checkout, into ``.cache/<key>/``
under this folder (``key``: a digest of what defines them), written to a
temporary name and renamed, and loaded by later runs.  ``--seed`` draws the
input features and the labels (here) and the weights and dropout masks (the
configuration's drawing, in the program and in the reference).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Tuple

import numpy as np

CACHE = Path(__file__).resolve().parents[1] / ".cache"


def write_fasta(path: str, n_seqs: int, seed: int, lo: int, hi: int) -> int:
    """Seeded FASTA over the 20 standard amino acids with ``sp|ID|...``
    headers, lengths uniform in [lo, hi]; returns the residue count."""
    rng = np.random.default_rng(seed)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    lens = rng.integers(lo, hi + 1, n_seqs)
    residues = aa[rng.integers(0, 20, int(lens.sum()))].tobytes().decode()
    pos = 0
    with open(path, "w") as fh:
        for i, n in enumerate(lens.tolist()):
            seq = residues[pos : pos + n]
            pos += n
            fh.write(f">sp|A{i:05d}|SYN{i}_HUMAN Synthetic protein {i}\n")
            fh.write("\n".join(seq[j : j + 60] for j in range(0, n, 60)) + "\n")
    return int(lens.sum())


def level_files(mix: dict, cache_root: Path = CACHE) -> Tuple[Path, Path]:
    """(FASTA, graph ``.npz``) of the mix's level, built where missing."""
    corpus = mix["corpus"]
    key = hashlib.sha256(json.dumps({"corpus": corpus, "n": mix["n"]},
                                    sort_keys=True).encode()).hexdigest()[:16]
    folder = Path(cache_root) / key
    folder.mkdir(parents=True, exist_ok=True)
    fasta = folder / "corpus.fasta"
    if not fasta.exists():
        tmp = folder / "corpus.tmp.fasta"
        write_fasta(str(tmp), corpus["sequences"], corpus["data_seed"], corpus["min_length"],
                    corpus["max_length"])
        os.replace(tmp, fasta)
    graph = folder / f"ngram_graph_n{mix['n']}.npz"
    if not graph.exists():
        from protgram_directgcn_torch.graph.builder import NgramGraphBuilder
        from protgram_directgcn_torch.graph.structure import save_graph
        from protgram_directgcn_torch.utils.io import parse_fasta

        level = NgramGraphBuilder(n_max=mix["n"]).build_from_sequences(
            list(parse_fasta(fasta)))[-1]
        tmp = folder / f"ngram_graph_n{mix['n']}.tmp.npz"
        save_graph(level, tmp)
        os.replace(tmp, graph)
    return fasta, graph


def draw_inputs(num_nodes: int, feat_dim: int, num_classes: int, seed: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Input features ``[N, feat_dim]`` float32 and labels ``[N]`` in
    ``[0, num_classes)``, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((num_nodes, feat_dim), dtype=np.float32)
    return x, rng.integers(0, num_classes, num_nodes).astype(np.int64)
