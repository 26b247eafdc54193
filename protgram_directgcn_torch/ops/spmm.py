"""Propagation operators: the dispatch over adjacency formats.

Port of protgram_directgcn_tpu/ops/spmm.py:90-100, 200-218, 580-698 for the
formats of this slice.  ``propagate(adj, x)[i] = sum over edges (j -> i) of
w * x[j]`` (reference: protgram_directgcn.py:100-140, PyG aggr='add').

- ``DenseAdj``: Aᵀ stored dense, one ``torch.matmul`` (the n = 1 level; the
  JAX package leaves this product to XLA as well);
- ``HypercubeAdj``: the gather-free K1/K2 pair (ops/hypercube.py).

ELL, bucketed ELL, COO and the block format are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch


@dataclasses.dataclass
class DenseAdj:
    """Dense Aᵀ (out[i] = sum_j at[i, j] x[j])."""

    at: torch.Tensor  # [n_out, n_in]

    @property
    def n_out(self) -> int:
        return self.at.shape[0]


def build_dense(src: np.ndarray, tgt: np.ndarray, w: np.ndarray, n_out: int,
                n_in: Optional[int] = None, dtype: torch.dtype = torch.float32,
                device: Union[str, torch.device] = "cuda") -> DenseAdj:
    n_in = n_out if n_in is None else n_in
    at = np.zeros((n_out, n_in), dtype=np.float32)
    if len(src):
        np.add.at(at, (np.asarray(tgt, np.int64), np.asarray(src, np.int64)),
                  np.asarray(w, np.float32))
    return DenseAdj(at=torch.from_numpy(at).to(device=device, dtype=dtype))


def propagate(adj, x: torch.Tensor) -> torch.Tensor:
    """Sum-aggregate weighted source features at each target node."""
    if isinstance(adj, DenseAdj):
        return adj.at @ x.to(adj.at.dtype)
    from protgram_directgcn_torch.ops import hypercube

    if isinstance(adj, hypercube.HypercubeAdj):
        return hypercube.propagate_hyper(adj, x)
    raise TypeError(f"Unknown adjacency type: {type(adj)}")


def propagate_transpose(adj, x: torch.Tensor) -> torch.Tensor:
    """The transpose product ``Mᵀ x`` (out[j] = sum over edges (j -> i) of
    w * x[i]), computed directly; differentiate :func:`propagate` instead."""
    if isinstance(adj, DenseAdj):
        return adj.at.T @ x.to(adj.at.dtype)
    from protgram_directgcn_torch.ops import hypercube

    if isinstance(adj, hypercube.HypercubeAdj):
        return hypercube.propagate_hyper_transpose(adj, x)
    raise TypeError(f"propagate_transpose: unsupported adjacency {type(adj)}")


def propagate3(graph, x_in: torch.Tensor, x_out: torch.Tensor, x_und: torch.Tensor):
    """The three per-path propagations of a DirectGCN layer."""
    return (
        propagate(graph.p_in, x_in),
        propagate(graph.p_out, x_out),
        propagate(graph.p_und, x_und),
    )
