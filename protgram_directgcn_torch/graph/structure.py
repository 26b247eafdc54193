"""N-gram graph containers: host arrays and the device propagation operators.

Port of protgram_directgcn_tpu/graph/structure.py:53-213.  ``NgramGraph`` and
its ``.npz`` format are the JAX package's, so either package reads the
other's graphs.  ``DeviceGraph`` holds torch operators (ops/spmm.py,
ops/block.py, ops/hypercube.py) for each of 𝒜_in, 𝒜_out and the undirected sym-norm
matrix, recomputed from the raw edges at load time
(reference: protgram_directgcn_trainer.py:294-299).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from protgram_directgcn_torch.graph import transforms
from protgram_directgcn_torch.ops.block import BlockNgramAdj
from protgram_directgcn_torch.ops.hypercube import HypercubeAdj
from protgram_directgcn_torch.ops.spmm import BucketedEllAdj, CooAdj, DenseAdj, EllAdj

Adjacency = Union[DenseAdj, EllAdj, BucketedEllAdj, CooAdj, BlockNgramAdj, HypercubeAdj]
_ROUTES = ((DenseAdj, "dense"), (HypercubeAdj, "hypercube"), (EllAdj, "ell"),
           (BucketedEllAdj, "bucketed"), (CooAdj, "coo"), (BlockNgramAdj, "block"))


@dataclasses.dataclass
class DeviceGraph:
    """Device propagation operators for one n-gram level.

    ``num_nodes`` is the node space the operators act on: the padded
    character hypercube [alphabet^n] for ``HypercubeAdj``, whose ``node_map``
    then holds the hypercube id of each real node (None for the others).
    The node-sharded operators of ``parallel/`` act on this rank's rows, and
    ``tri`` holds their layer-level operator (one exchange for the three
    matrices, run by ``spmm.propagate3``).
    """

    p_in: Adjacency  # from 𝒜_in  (built from A_in_w = A_out_wᵀ)
    p_out: Adjacency  # from 𝒜_out (built from A_out_w)
    p_und: Adjacency  # undirected sym-norm matrix
    num_nodes: int = 0
    node_map: Optional[torch.Tensor] = None
    tri: Optional[object] = None

    @property
    def route(self) -> str:
        """The format of ``p_in``: dense, hypercube, ell, bucketed, coo or
        block; halo or hyper_shard for a node-sharded operator."""
        own = getattr(type(self.p_in), "route", None)
        return own or next(name for cls, name in _ROUTES if isinstance(self.p_in, cls))


@dataclasses.dataclass
class NgramGraph:
    """Directed weighted n-gram transition graph (host side)."""

    n: int
    vocab: np.ndarray  # [N] of str, sorted ascending; id == index
    src: np.ndarray  # [E] int32 unique edge sources
    tgt: np.ndarray  # [E] int32 unique edge targets
    weight: np.ndarray  # [E] float32 transition counts
    epsilon_propagation: float = 1e-9

    _node_to_idx: Optional[Dict[str, int]] = dataclasses.field(default=None, repr=False)

    @property
    def num_nodes(self) -> int:
        return len(self.vocab)

    @property
    def num_edges(self) -> int:
        return len(self.src)

    @property
    def node_to_idx(self) -> Dict[str, int]:
        if self._node_to_idx is None:
            self._node_to_idx = {s: i for i, s in enumerate(self.vocab.tolist())}
        return self._node_to_idx

    def a_out_w(self):
        return transforms.coalesce_coo(self.src, self.tgt, self.weight, self.num_nodes)

    def mathcal_a_out(self):
        return transforms.directgcn_propagation_matrix(self.a_out_w(), self.epsilon_propagation)

    def mathcal_a_in(self):
        # A_in_w = A_out_wᵀ (reference: graph_utils.py:158)
        return transforms.directgcn_propagation_matrix(
            self.a_out_w().T.tocsr(), self.epsilon_propagation
        )

    def undirected_norm(self):
        return transforms.undirected_normalized_matrix(self.src, self.tgt, self.num_nodes)

    def to_device(self, mode: str = "auto", feat_dim: int = 128,
                  dtype: torch.dtype = torch.float32,
                  device: Union[str, torch.device] = "cuda",
                  hbm_budget: int = 10 << 30) -> DeviceGraph:
        """Materialise the three propagation operators on ``device``
        (structure.py:100-175 of the JAX package).

        ``mode``: "hypercube" (gather-free banks over [alphabet^n], n >= 2;
        the three matrices share ``hbm_budget``), or a format of
        ``spmm.build_adjacency``: "auto" (chosen by its byte model for
        ``feat_dim``-wide features; at n >= 2 it may take the block format
        over the vocabulary's (n-1)-gram keys), "dense", "ell" ("pallas" is
        "ell"), "bucketed", "coo" or "block".  The 𝒜 matrices are symmetric-pattern by
        construction, so (row→col) edges feed the (src→tgt,
        aggregate-at-tgt) operator directly
        (reference: protgram_directgcn_trainer.py:362-367).
        """
        from protgram_directgcn_torch.ops.hypercube import build_hypercube, vocab_char_codes
        from protgram_directgcn_torch.ops.block import ngram_node_keys
        from protgram_directgcn_torch.ops.spmm import build_adjacency

        mats = (self.mathcal_a_in(), self.mathcal_a_out(), self.undirected_norm())
        if mode == "hypercube":
            codes, alpha = vocab_char_codes(self.vocab)
            ops = [
                build_hypercube(*transforms.csr_to_coo_arrays(m), codes, alpha,
                                max_block_bytes=hbm_budget // 3, weights_dtype=dtype,
                                device=device)
                for m in mats
            ]
            return DeviceGraph(*ops, num_nodes=ops[0].n_out, node_map=ops[0].node_map)
        n = self.num_nodes
        node_keys = ngram_node_keys(self.vocab) if self.n >= 2 and n else None
        ops = [build_adjacency(*transforms.csr_to_coo_arrays(m), n, mode=mode,
                               feat_dim=feat_dim, dtype=dtype, node_keys=node_keys,
                               device=device)
               for m in mats]
        return DeviceGraph(*ops, num_nodes=n)

    def lookup(self, ngrams: np.ndarray) -> np.ndarray:
        """Map n-gram strings to ids; -1 where absent."""
        pos = np.searchsorted(self.vocab, ngrams)
        pos = np.clip(pos, 0, self.num_nodes - 1)
        found = self.vocab[pos] == ngrams
        return np.where(found, pos, -1).astype(np.int64)


def save_graph(graph: NgramGraph, path: os.PathLike) -> None:
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        n=np.int64(graph.n),
        vocab=graph.vocab.astype(np.str_),
        src=graph.src.astype(np.int32),
        tgt=graph.tgt.astype(np.int32),
        weight=graph.weight.astype(np.float32),
        epsilon=np.float64(graph.epsilon_propagation),
    )


def load_graph(path: os.PathLike) -> NgramGraph:
    with np.load(path, allow_pickle=False) as z:
        return NgramGraph(
            n=int(z["n"]),
            vocab=z["vocab"],
            src=z["src"],
            tgt=z["tgt"],
            weight=z["weight"],
            epsilon_propagation=float(z["epsilon"]),
        )
