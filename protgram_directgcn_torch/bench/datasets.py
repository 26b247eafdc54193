"""Node-classification benchmark datasets.

Port of protgram_directgcn_tpu/bench/datasets.py (reference:
gnn_benchmarker.py:54-119, config.py:49-52): KarateClub (Zachary's graph and
its "club" labels as constants here, networkx's ``karate_club_graph``), and
Planetoid (Cora/CiteSeer/PubMed) and WebKB (Cornell/Texas/Wisconsin) from
raw files under a dataset root.  Where the raw files are absent a logged,
seeded synthetic stand-in with the dataset's task shape takes their place,
as in the JAX package.  The stand-in's seed is ``seed + hash(name) % 1000``,
the JAX package's expression: Python salts ``str`` hashes per process, so a
stand-in differs from one process to the next (in both packages alike)
unless ``PYTHONHASHSEED`` is fixed.
"""

from __future__ import annotations

import os
import pickle
import sys
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from protgram_directgcn_torch.utils.io import logger


@dataclass
class NodeClassificationDataset:
    name: str
    x: np.ndarray  # [N, F] float32
    edge_index: np.ndarray  # [2, E] int64 (directed as stored)
    y: np.ndarray  # [N] int64
    train_mask: Optional[np.ndarray] = None
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None
    synthetic: bool = False

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_classes(self) -> int:
        return int(self.y.max()) + 1 if self.y.size else 1

    def undirected(self) -> "NodeClassificationDataset":
        """Symmetrized unique edge set (PyG to_undirected semantics)."""
        pairs = np.concatenate([self.edge_index.T, self.edge_index.T[:, ::-1]], axis=0)
        pairs = np.unique(pairs, axis=0)
        return NodeClassificationDataset(
            name=self.name, x=self.x, edge_index=pairs.T.copy(), y=self.y,
            train_mask=self.train_mask, val_mask=self.val_mask, test_mask=self.test_mask,
            synthetic=self.synthetic,
        )


# Zachary's karate club: networkx's ``karate_club_graph().edges()`` in its
# order, and each member's club (0: "Mr. Hi", 1: "Officer").
KARATE_EDGES = (
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10), (0, 11), (0, 12),
    (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2), (1, 3), (1, 7), (1, 13), (1, 17),
    (1, 19), (1, 21), (1, 30), (2, 3), (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28),
    (2, 32), (3, 7), (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
    (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33), (15, 32), (15, 33),
    (18, 32), (18, 33), (19, 33), (20, 32), (20, 33), (22, 32), (22, 33), (23, 25), (23, 27),
    (23, 29), (23, 32), (23, 33), (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33),
    (27, 33), (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32), (31, 33),
    (32, 33),
)
KARATE_CLUB = (0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1)


def karate_club() -> NodeClassificationDataset:
    """Zachary's karate club: identity features, 2-class 'club' labels, both
    edge directions."""
    n = len(KARATE_CLUB)
    edges = np.array(KARATE_EDGES, dtype=np.int64)
    edge_index = np.concatenate([edges, edges[:, ::-1]], axis=0).T  # undirected
    y = np.array(KARATE_CLUB, dtype=np.int64)
    return NodeClassificationDataset(
        name="KarateClub", x=np.eye(n, dtype=np.float32), edge_index=edge_index, y=y
    )


def _parse_planetoid(root: str, name: str) -> Optional[NodeClassificationDataset]:
    """Standard 'ind.<name>.*' Planetoid raw format parser."""
    import scipy.sparse as sp

    lname = name.lower()
    raw = os.path.join(root, name, "raw")
    files = [f"ind.{lname}.{s}" for s in ("x", "tx", "allx", "y", "ty", "ally", "graph", "test.index")]
    if not all(os.path.exists(os.path.join(raw, f)) for f in files):
        return None

    objs = {}
    for suffix in ("x", "tx", "allx", "y", "ty", "ally", "graph"):
        with open(os.path.join(raw, f"ind.{lname}.{suffix}"), "rb") as f:
            objs[suffix] = pickle.load(f, encoding="latin1") if sys.version_info[0] >= 3 else pickle.load(f)
    test_idx = np.loadtxt(os.path.join(raw, f"ind.{lname}.test.index"), dtype=np.int64)
    test_sorted = np.sort(test_idx)

    allx, tx = objs["allx"].tolil(), objs["tx"].tolil()
    ally, ty = objs["ally"], objs["ty"]
    if lname == "citeseer":
        # Citeseer has isolated test nodes: reindex into the full range.
        full = np.arange(test_sorted[0], test_sorted[-1] + 1)
        tx_ext = sp.lil_matrix((len(full), allx.shape[1]))
        tx_ext[test_sorted - test_sorted[0]] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), ally.shape[1]))
        ty_ext[test_sorted - test_sorted[0]] = ty
        ty = ty_ext

    x = sp.vstack([allx, tx]).tolil()
    x[test_idx] = x[np.sort(test_idx)]
    y_onehot = np.vstack([ally, ty])
    y_onehot[test_idx] = y_onehot[np.sort(test_idx)]
    y = y_onehot.argmax(axis=1).astype(np.int64)

    n = x.shape[0]
    src, tgt = [], []
    for node, nbrs in objs["graph"].items():
        for nb in nbrs:
            if node < n and nb < n:
                src.append(node)
                tgt.append(nb)
    edge_index = np.unique(np.stack([src, tgt], axis=1), axis=0).T.astype(np.int64)

    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    n_train = objs["y"].shape[0]
    train_mask[:n_train] = True
    val_mask[n_train : n_train + 500] = True
    test_mask[test_idx] = True
    return NodeClassificationDataset(
        name=name, x=np.asarray(x.todense(), np.float32), edge_index=edge_index, y=y,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
    )


def _parse_webkb(root: str, name: str) -> Optional[NodeClassificationDataset]:
    """WebKB raw format: out1_node_feature_label.txt + out1_graph_edges.txt."""
    raw = os.path.join(root, name, "raw")
    feat_file = os.path.join(raw, "out1_node_feature_label.txt")
    edge_file = os.path.join(raw, "out1_graph_edges.txt")
    if not (os.path.exists(feat_file) and os.path.exists(edge_file)):
        return None
    xs, ys = [], []
    with open(feat_file) as f:
        next(f)  # header
        for line in f:
            _, feat, label = line.strip().split("\t")
            xs.append([float(v) for v in feat.split(",")])
            ys.append(int(label))
    edges = []
    with open(edge_file) as f:
        next(f)
        for line in f:
            a, b = line.strip().split("\t")
            edges.append((int(a), int(b)))
    edge_index = np.unique(np.array(edges, np.int64), axis=0).T
    return NodeClassificationDataset(
        name=name, x=np.array(xs, np.float32), edge_index=edge_index,
        y=np.array(ys, np.int64),
    )


_SYNTH_SHAPES: Dict[str, Dict] = {
    "Cora": dict(n=2708, f=1433, c=7, deg=4),
    "CiteSeer": dict(n=3327, f=3703, c=6, deg=3),
    "PubMed": dict(n=19717, f=500, c=3, deg=5),
    "Cornell": dict(n=183, f=1703, c=5, deg=2),
    "Texas": dict(n=183, f=1703, c=5, deg=2),
    "Wisconsin": dict(n=251, f=1703, c=5, deg=2),
}


def synthetic_stand_in(name: str, seed: int = 42) -> NodeClassificationDataset:
    """Seeded feature-correlated SBM matching the real dataset's task shape.

    Features mimic the REAL datasets' regime — sparse binary bag-of-words
    rows (the raw Planetoid ind.* statistics; the reference loads them
    untransformed) — not dense gaussians: dense high-dimensional features
    are ~30x larger in norm and blow up models that sum several
    unnormalized propagations (DirectGCN's six paths), which the real data
    never exercises."""
    spec = _SYNTH_SHAPES.get(name, dict(n=500, f=64, c=4, deg=4))
    n, f, c, deg = spec["n"], min(spec["f"], 256), spec["c"], spec["deg"]
    rng = np.random.default_rng(seed + hash(name) % 1000)
    y = rng.integers(0, c, n)
    # Per-class vocabulary: class words are ~6x likelier than background.
    base_p = min(1.0, 8.0 / f)
    word_p = np.full((c, f), base_p, np.float32)
    n_class_words = max(4, f // 8)
    for cls in range(c):
        word_p[cls, rng.choice(f, n_class_words, replace=False)] = min(1.0, 48.0 / f)
    x = (rng.random((n, f)) < word_p[y]).astype(np.float32)
    x[x.sum(1) == 0, 0] = 1.0  # no empty rows (raw binary BoW, like ind.* files)
    src = np.repeat(np.arange(n), deg)
    # 70% intra-class edges, 30% random.
    tgt = np.empty(n * deg, dtype=np.int64)
    intra = rng.random(n * deg) < 0.7
    for cls in range(c):
        members = np.nonzero(y == cls)[0]
        sel = intra & (y[src] == cls)
        tgt[sel] = rng.choice(members, sel.sum())
    tgt[~intra] = rng.integers(0, n, (~intra).sum())
    edge_index = np.unique(np.stack([src, tgt], axis=1), axis=0)
    edge_index = edge_index[edge_index[:, 0] != edge_index[:, 1]].T
    return NodeClassificationDataset(
        name=name, x=x, edge_index=edge_index.astype(np.int64), y=y.astype(np.int64),
        synthetic=True,
    )


def load_dataset(name: str, root: Optional[os.PathLike] = None, seed: int = 42) -> NodeClassificationDataset:
    if name.lower() == "karateclub":
        return karate_club()
    root = str(root) if root else ""
    ds = None
    if name.lower() in ("cora", "citeseer", "pubmed") and root:
        ds = _parse_planetoid(root, name)
    elif name.lower() in ("cornell", "texas", "wisconsin") and root:
        ds = _parse_webkb(root, name)
    if ds is None:
        logger.warning("dataset %s: raw files not found (no network egress) — using seeded synthetic stand-in", name)
        ds = synthetic_stand_in(name, seed)
    return ds
