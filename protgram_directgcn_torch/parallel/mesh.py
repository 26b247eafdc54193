"""The rank grid, and the sharding of a level's operators, parameters and
inputs over it.

Port of protgram_directgcn_tpu/parallel/mesh.py.  The JAX package's
("nodes", "feat") mesh becomes a 2-D grid of the process group's ranks
(``make_mesh``): rank = node_rank * Df + feat_rank, the row-major reshape
of the JAX mesh.  The ranks of one feature shard (one column of the grid)
form the node group, over which the operators exchange rows; the ranks of
one node shard form the feature group.

Node axis.  Each rank keeps its node rows of the per-node parameters
(``c_in, c_out, c_directed, c_undirected, c_all, constant``, mesh.py:107)
and of the inputs.  A rank's rows are its operators' ``node_rows()``: a
contiguous block in halo and gspmd modes (``build_distributed_device_graph``,
``shard_device_graph``), the rank's key slab ``[A, Gd]`` of the padded
hypercube ids in hypercube mode, so that the node parameters, labels and
mask lie in the order of the rank's features.

Feature axis (``mesh_feats`` = Df > 1, mesh.py:107-144).  The projection
weights ``w_main_in, w_main_out, w_und, w_shared`` and ``res_projs[*].w``
keep output columns ``[f0:f1]``, the biases the same columns, the decoder
``w1`` columns, ``b1`` the same, ``w2`` rows; ``b2``, ``pe_table`` and
scalar gates are replicated, and the node leaves are replicated over the
feature axis.  A layer's projections give the rank its columns, and since
propagation acts on each column on its own, each rank propagates only its
columns (K1/K2 or the ELL kernels at width F / Df), where the JAX package
all-gathers to full width before its halo ``shard_map`` (halo.py:225-231):
the same numbers at 1 / Df of the propagation work.  Whole rows are
gathered over the feature group between layers (``FeatShard.gather``,
whose backward sums the cotangent over the group and keeps this rank's
columns), and the decoder's partial logits are summed over it
(``FeatShard.sum``, ``b2`` counted on feature rank 0 alone).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from protgram_directgcn_torch.graph.structure import DeviceGraph
from protgram_directgcn_torch.graph.transforms import csr_to_coo_arrays
from protgram_directgcn_torch.parallel import distributed as comm
from protgram_directgcn_torch.parallel.gspmd import (
    RowShardEllAdj,
    RowShardTri,
    build_row_shard_tables,
)
from protgram_directgcn_torch.parallel.halo import HaloAdj, build_tri_halo_adjacency

NODE_SHARDED_KEYS = frozenset({"c_in", "c_out", "c_directed", "c_undirected", "c_all", "constant"})
# Leaves sharded over the feature axis, by the axis they split: output
# columns of the projections, res_projs[*].w and decoder.w1; the biases,
# decoder.b1 and the rows of decoder.w2.
_FEAT_COLS = frozenset({"w_main_in", "w_main_out", "w_und", "w_shared", "w", "w1"})
_FEAT_ROWS = frozenset({"b", "b1", "w2"})


def feat_axis(name: str) -> Optional[int]:
    """The axis a leaf of this name splits over the feature shards, or None
    (replicated, or a node leaf)."""
    if name in _FEAT_COLS:
        return 1
    if name in _FEAT_ROWS or name.startswith("b_"):
        return 0
    return None


class _GatherCols(torch.autograd.Function):
    """Whole rows from every feature rank's columns; the backward sums the
    cotangent over the group (each rank's is the partial of its own columns'
    downstream work) and keeps this rank's columns."""

    @staticmethod
    def forward(ctx, t, feat):
        ctx.feat, ctx.width = feat, t.shape[-1]
        return torch.cat(comm.all_gather(t.contiguous(), feat.group), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        total = comm.all_reduce_sum(grad.float().contiguous().clone(), ctx.feat.group)
        r, w = ctx.feat.rank, ctx.width
        return total[..., r * w:(r + 1) * w].to(grad.dtype).contiguous(), None


class _SumRanks(torch.autograd.Function):
    """The sum of every feature rank's partial; the backward is the identity
    (every rank holds the whole cotangent of the replicated sum)."""

    @staticmethod
    def forward(ctx, t, feat):
        return comm.all_reduce_sum(t.float().contiguous().clone(), feat.group).to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclasses.dataclass(frozen=True)
class FeatShard:
    """This rank's place among the feature shards of its node shard."""

    shards: int
    rank: int
    group: Any = None  # the ranks of this node shard (None: the world)

    def cols(self, width: int) -> slice:
        """This rank's columns of a ``width``-wide full row."""
        return slice(self.rank * width, (self.rank + 1) * width)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return _GatherCols.apply(t, self)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return _SumRanks.apply(t, self)


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """This process's place in the rank grid: ``rank`` is its node shard,
    ``feat_rank`` its feature shard; ``node_group`` holds the ranks of this
    feature shard, ``feat_group`` those of this node shard (None: the
    world)."""

    node_shards: int
    rank: int
    feat_shards: int = 1
    feat_rank: int = 0
    node_group: Any = None
    feat_group: Any = None

    @property
    def feat(self) -> Optional[FeatShard]:
        if self.feat_shards == 1:
            return None
        return FeatShard(self.feat_shards, self.feat_rank, self.feat_group)


def make_mesh(num_devices: Optional[int] = None, feat_axis: int = 1) -> RankLayout:
    """The rank grid of ``num_devices`` node shards (default: the world size
    over ``feat_axis``) by ``feat_axis`` feature shards, rank = node_rank *
    feat_axis + feat_rank (mesh.py:35-43).  Raises unless the world size is
    their product.  Every rank makes every group, in one order."""
    world = comm.world_size()
    df = int(feat_axis)
    if df < 1:
        raise ValueError(f"parallel.mesh_feats={df}: needs at least 1 feature shard")
    dn = world // df if num_devices is None else int(num_devices)
    if dn * df != world:
        raise ValueError(f"parallel.mesh_nodes={dn} x parallel.mesh_feats={df} shards need "
                         f"{dn * df} processes (one a device, e.g. torchrun --nproc-per-node "
                         f"{dn * df}); this run has world size {world}")
    me = comm.rank()
    node_groups = [comm.new_group([n * df + f for n in range(dn)]) for f in range(df)]
    feat_groups = [comm.new_group([n * df + f for f in range(df)]) for n in range(dn)]
    return RankLayout(node_shards=dn, rank=me // df, feat_shards=df, feat_rank=me % df,
                      node_group=node_groups[me % df], feat_group=feat_groups[me // df])


def build_distributed_device_graph(graph, layout: RankLayout, debug_checksums: bool = False,
                                   device="cuda") -> DeviceGraph:
    """This rank's halo operators for 𝒜_in, 𝒜_out and the undirected matrix,
    and the layer-level operator that serves all three with one exchange
    (mesh.py:147-183).  ``num_nodes`` is the rank's row count.

    Where the JAX package builds each matrix's partition on its own plan as
    well as the three on the shared plan, the port builds the shared plan
    only and takes each matrix's operator from it: the same edges in the
    same slots, read from the union receive buffer (a superset of the
    matrix's own), so the same products at half the host build."""
    coos = [csr_to_coo_arrays(m)
            for m in (graph.mathcal_a_in(), graph.mathcal_a_out(), graph.undirected_norm())]
    tri = build_tri_halo_adjacency(coos, graph.num_nodes, layout.node_shards, layout.rank,
                                   device, debug_checksums, layout.node_group)
    ops = [HaloAdj(fwd=f, bwd=b) for f, b in zip(tri.fwd.parts, tri.bwd.parts)]
    return DeviceGraph(*ops, num_nodes=ops[0].n_out, tri=tri, feat=layout.feat)


def shard_device_graph(graph, layout: RankLayout, device="cuda") -> DeviceGraph:
    """This rank's rows of the level's ELL operators, both orientations
    (``shard_device_graph``, mesh.py:63-104, over ``to_device(mode="ell")``'s
    tables: f32 weights whatever the compute type, as the port's ELL), and
    the layer-level operator with one gather for the three matrices."""
    ops = [RowShardEllAdj.from_tables(
        build_row_shard_tables(*csr_to_coo_arrays(m), graph.num_nodes, layout.node_shards),
        layout.node_shards, layout.rank, device, layout.node_group)
        for m in (graph.mathcal_a_in(), graph.mathcal_a_out(), graph.undirected_norm())]
    return DeviceGraph(*ops, num_nodes=ops[0].n_out, tri=RowShardTri(adjs=tuple(ops)),
                       feat=layout.feat)


def _is_node_leaf(key: str, v: Any, n_global: int) -> bool:
    return (key in NODE_SHARDED_KEYS and isinstance(v, torch.Tensor) and v.dim() >= 1
            and v.shape[0] == n_global)


def _feat_slice(t: torch.Tensor, axis: int, feat: FeatShard) -> torch.Tensor:
    width = t.shape[axis] // feat.shards
    return t.narrow(axis, feat.rank * width, width).contiguous()


def check_feat_widths(params: Any, feat_shards: int) -> None:
    """Raise ValueError naming the first feature-sharded leaf whose split
    width ``feat_shards`` does not divide (JAX ``device_put`` refuses it)."""
    for name, v in _named(params, ""):
        ax = feat_axis(name.rsplit(".", 1)[-1])
        if ax is not None and v.dim() > ax and v.shape[ax] % feat_shards:
            raise ValueError(f"parallel.mesh_feats={feat_shards} does not divide the width "
                             f"{v.shape[ax]} of {name} (axis {ax}, shape {list(v.shape)})")


def _named(t, prefix):
    if isinstance(t, torch.Tensor):
        yield prefix, t
    elif isinstance(t, dict):
        for k in sorted(t):
            yield from _named(t[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _named(v, f"{prefix}[{i}]")


def shard_model_params(params: Any, rows: torch.Tensor, n_global: int,
                       feat: Optional[FeatShard] = None) -> Any:
    """A parameter tree over ``n_global`` nodes cut to this rank: node leaves
    (flat ``[n_global, ...]``) keep their ``rows``; under ``feat`` the
    feature-sharded leaves keep this rank's columns (or rows: ``feat_axis``);
    every other leaf is kept whole (mesh.py:111-144).  Works on the
    trainer's tree and on one that ``convert.params_from_jax`` carried over.
    Raises ValueError where a width is not a multiple of the feature shards."""
    if feat is not None:
        check_feat_widths(params, feat.shards)

    def cut(t, key):
        if isinstance(t, dict):
            return {k: cut(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [cut(v, key) for v in t]
        if _is_node_leaf(key, t, n_global):
            return t[rows.to(t.device)].contiguous()
        if feat is not None and isinstance(t, torch.Tensor) and feat_axis(key) is not None:
            return _feat_slice(t, feat_axis(key), feat)
        return t

    out = dict(params)
    for k in ("layers", "res_projs", "decoder"):
        out[k] = cut(params[k], k)
    return out


def node_sharded(name: str, p: torch.Tensor, n_local: int) -> bool:
    """Whether a leaf of a sharded tree holds this rank's node rows."""
    return name in NODE_SHARDED_KEYS and p.dim() >= 1 and p.shape[0] == n_local


def shard_training_inputs(x: np.ndarray, y: np.ndarray, mask: np.ndarray, adj, device,
                          x_dtype: torch.dtype = torch.float32):
    """This rank's rows of inputs over the padded node space (mesh.py:186-192):
    features rg ``[A, Gd, F]`` on a hypercube shard, else ``[Nd, F]``; labels
    int64 and mask f32 ``[rows]``.  Features are whole rows on every
    feature shard."""
    rows = adj.node_rows().cpu().numpy()
    xs = torch.from_numpy(np.ascontiguousarray(x[rows])).to(device=device, dtype=x_dtype)
    lead = getattr(adj, "feature_shape", None)
    if lead is not None:
        xs = xs.reshape(tuple(lead) + (x.shape[1],))
    return (xs, torch.from_numpy(np.ascontiguousarray(y[rows]).astype(np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(mask[rows]).astype(np.float32)).to(device))


def gather_rows(local: torch.Tensor, adj, n_global: int, group: Any = None) -> torch.Tensor:
    """Every node shard's rows of a flat per-node tensor ``[rows, ...]``
    placed at their global ids, on every rank of the node ``group``:
    ``[n_global, ...]``."""
    parts = comm.all_gather(local.contiguous(), group)
    out = local.new_zeros((n_global,) + tuple(local.shape[1:]))
    rows_local = adj.node_rows()
    for r, part in enumerate(parts):
        out[_rows_of_rank(adj, r, rows_local)] = part.to(out.device)
    return out


def _rows_of_rank(adj, r: int, rows_local: torch.Tensor) -> torch.Tensor:
    """The global ids of node shard ``r``'s rows (every shard's slab has the
    shape of this one's)."""
    if getattr(adj, "feature_shape", None) is None:  # halo, gspmd: contiguous blocks
        nd = adj.n_out
        return torch.arange(r * nd, (r + 1) * nd, device=rows_local.device)
    gd = adj.feature_shape[1]
    return rows_local + (r - adj.rank) * gd
