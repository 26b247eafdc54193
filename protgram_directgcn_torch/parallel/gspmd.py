"""The ``gspmd`` mode: ELL operators row-sharded over the node shards.

Port of the JAX package's ``parallel.mode="gspmd"`` (mesh.py:63-104,
trainer.py:1881-1889).  There the ELL tables' rows (``idx, w, idx_t, w_t``,
padded to a multiple of the node shards) and the features are sharded along
"nodes", and GSPMD inserts whatever collective the gather ``x[idx]`` needs.
The port writes that collective out: each rank keeps its contiguous block of
``rows_per_shard`` rows of both orientations, whose entries are global
column ids, and one propagation is

    all_gather of the node-sharded x ``[Nd, F]`` over the node group
    ->  ``[N_pad, F]``  ->  this rank's rows through the ELL kernel.

The backward is the same with the transpose table and the gathered
cotangent: the transpose's rows are local too, so no reduce-scatter is
needed.  On the card both directions run ``ell_resident`` / ``ell_hbm``
(picked by the gathered table's rows, as on one device), on the CPU their
plain version.  ``RowShardTri`` serves a layer's three matrices with one
gather of their concatenated columns (the JAX package gathers per matrix).
Each rank holds the whole gathered ``[N_pad, F]``, so the mode trades
halo mode's exchange plan for that memory and traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from protgram_directgcn_torch.ops.spmm import _ell_one_sided
from protgram_directgcn_torch.parallel import distributed as comm
from protgram_directgcn_torch.parallel.halo import _ell_block


def build_row_shard_tables(src, tgt, w, num_nodes: int, num_shards: int) -> Dict[str, Any]:
    """The ELL tables of one matrix in both orientations (``spmm.build_ell``'s
    arrays), their rows zero-padded to a multiple of ``num_shards``
    (mesh.py:77-84): ``idx, w, idx_t, w_t`` ``[N_pad, K]`` and
    ``rows_per_shard``."""
    idx, wm = _ell_one_sided(src, tgt, w, num_nodes)
    idx_t, wm_t = _ell_one_sided(tgt, src, w, num_nodes)
    nd = -(-num_nodes // num_shards)
    pad = nd * num_shards - num_nodes

    def rows(a):
        return np.pad(a, ((0, pad), (0, 0))) if pad else a

    return {"idx": rows(idx), "w": rows(wm), "idx_t": rows(idx_t), "w_t": rows(wm_t),
            "rows_per_shard": nd}


@dataclasses.dataclass
class RowShardEllAdj:
    """This rank's block of rows of a matrix's ELL tables, both orientations."""

    idx: torch.Tensor  # [Nd, K] int32 global source ids
    w: torch.Tensor  # [Nd, K] f32
    idx_t: torch.Tensor  # [Nd, Kt] int32 global target ids
    w_t: torch.Tensor  # [Nd, Kt] f32
    num_shards: int = 1
    rank: int = 0
    group: Any = None  # the node shards' process group (None: the world)
    route = "gspmd"

    @classmethod
    def from_tables(cls, tables: Dict[str, Any], num_shards: int, rank: int, device,
                    group: Any = None) -> "RowShardEllAdj":
        nd = int(tables["rows_per_shard"])
        block = slice(rank * nd, (rank + 1) * nd)
        return cls(**{k: torch.from_numpy(np.ascontiguousarray(tables[k][block])).to(device)
                      for k in ("idx", "w", "idx_t", "w_t")},
                   num_shards=int(num_shards), rank=int(rank), group=group)

    @property
    def n_out(self) -> int:
        """This rank's rows."""
        return self.idx.shape[0]

    @property
    def global_nodes(self) -> int:
        return self.num_shards * self.idx.shape[0]

    def node_rows(self) -> torch.Tensor:
        start = self.rank * self.n_out
        return torch.arange(start, start + self.n_out, device=self.idx.device)


def _gather(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Every node shard's rows of ``x``, in rank order: ``[N_pad, F]``."""
    return torch.cat(comm.all_gather(x.contiguous(), group, count=True), dim=0)


def _products(adjs, xs, transpose: bool) -> Tuple[torch.Tensor, ...]:
    """Each matrix's rows of this rank over its gathered input, the inputs'
    columns sharing one gather."""
    direction = "bwd" if transpose else "fwd"
    f = xs[0].shape[1]
    full = _gather(torch.cat([x.to(xs[0].dtype) for x in xs], dim=1), adjs[0].group)
    outs = []
    for m, adj in enumerate(adjs):
        table = full if len(xs) == 1 else full[:, m * f:(m + 1) * f].contiguous()
        idx, w = (adj.idx_t, adj.w_t) if transpose else (adj.idx, adj.w)
        outs.append(_ell_block(idx, w, table, direction))
    return tuple(outs)


class _RowShardProp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return _products([adj], [x], False)[0]

    @staticmethod
    def backward(ctx, grad):
        return _products([ctx.adj], [grad], True)[0], None


def propagate(adj: RowShardEllAdj, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the product; ``x`` is the rank's rows ``[Nd, F]``."""
    return _RowShardProp.apply(x, adj)


@dataclasses.dataclass
class RowShardTri:
    """A layer's three matrices (in, out, und) with one gather a direction."""

    adjs: Tuple[RowShardEllAdj, RowShardEllAdj, RowShardEllAdj]


class _RowShardTriProp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, x1, x2, tri):
        ctx.tri = tri
        return _products(tri.adjs, (x0, x1, x2), False)

    @staticmethod
    def backward(ctx, g0, g1, g2):
        return (*_products(ctx.tri.adjs, (g0, g1, g2), True), None)


def propagate_tri(tri: RowShardTri, x_in, x_out, x_und):
    return _RowShardTriProp.apply(x_in, x_out, x_und, tri)
