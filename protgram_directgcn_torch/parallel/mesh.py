"""The rank layout, and the sharding of a level's operators, parameters and
inputs over it.

Port of protgram_directgcn_tpu/parallel/mesh.py for the ``halo`` and
``hypercube`` modes.  The JAX package's ("nodes", "feat") mesh becomes the
ranks of the process group, one node shard each (``make_mesh``); the
feature axis and the gspmd row sharding are not ported (ROADMAP Queue 1,
item 13b).  Each rank keeps its node rows of the per-node parameters
(``c_in, c_out, c_directed, c_undirected, c_all, constant``, mesh.py:107)
and of the inputs, and a replica of every other leaf.  A rank's rows are its
operators' ``node_rows()``: a contiguous block in halo mode, the rank's key
slab ``[A, Gd]`` of the padded hypercube ids in hypercube mode, so that the
node parameters, labels and mask lie in the order of the rank's features.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from protgram_directgcn_torch.graph.structure import DeviceGraph
from protgram_directgcn_torch.graph.transforms import csr_to_coo_arrays
from protgram_directgcn_torch.parallel import distributed as comm
from protgram_directgcn_torch.parallel.halo import HaloAdj, build_tri_halo_adjacency

NODE_SHARDED_KEYS = frozenset({"c_in", "c_out", "c_directed", "c_undirected", "c_all", "constant"})
_UNPORTED = "(ROADMAP Queue 1, item 13b)"


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """This process's place among the node shards."""

    node_shards: int
    rank: int


def make_mesh(num_devices: Optional[int] = None, feat_axis: int = 1) -> RankLayout:
    """The rank layout of ``num_devices`` node shards (default: the world
    size), one per rank (mesh.py:35-43).  Raises unless the world size is
    ``num_devices``."""
    if int(feat_axis) > 1:
        raise NotImplementedError(f"parallel.mesh_feats={feat_axis}: feature-sharded weights "
                                  f"are not ported yet {_UNPORTED}")
    world = comm.world_size()
    shards = world if num_devices is None else int(num_devices)
    if shards != world:
        raise ValueError(f"parallel.mesh_nodes={shards} node shards need {shards} processes "
                         f"(one a device, e.g. torchrun --nproc-per-node {shards}); "
                         f"this run has world size {world}")
    return RankLayout(node_shards=shards, rank=comm.rank())


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
                                   device, debug_checksums)
    ops = [HaloAdj(fwd=f, bwd=b) for f, b in zip(tri.fwd.parts, tri.bwd.parts)]
    return DeviceGraph(*ops, num_nodes=ops[0].n_out, tri=tri)


def _is_node_leaf(key: str, v: Any, n_global: int) -> bool:
    return (key in NODE_SHARDED_KEYS and isinstance(v, torch.Tensor) and v.dim() >= 1
            and v.shape[0] == n_global)


def shard_model_params(params: Any, rows: torch.Tensor, n_global: int) -> Any:
    """A parameter tree over ``n_global`` nodes cut to this rank: node leaves
    (flat ``[n_global, ...]``) keep their ``rows``, every other leaf is kept
    whole (mesh.py:111-144).  Works on the trainer's tree and on one that
    ``convert.params_from_jax`` carried over."""

    def layer(lp):
        return {k: (v[rows.to(v.device)].contiguous() if _is_node_leaf(k, v, n_global) else v)
                for k, v in lp.items()}

    out = dict(params)
    out["layers"] = [layer(lp) for lp in params["layers"]]
    return out


def node_sharded(name: str, p: torch.Tensor, n_local: int) -> bool:
    """Whether a leaf of a sharded tree holds this rank's node rows."""
    return name in NODE_SHARDED_KEYS and p.dim() >= 1 and p.shape[0] == n_local


def shard_training_inputs(x: np.ndarray, y: np.ndarray, mask: np.ndarray, adj, device,
                          x_dtype: torch.dtype = torch.float32):
    """This rank's rows of inputs over the padded node space (mesh.py:186-192):
    features rg ``[A, Gd, F]`` on a hypercube shard, else ``[Nd, F]``; labels
    int64 and mask f32 ``[rows]``."""
    rows = adj.node_rows().cpu().numpy()
    xs = torch.from_numpy(np.ascontiguousarray(x[rows])).to(device=device, dtype=x_dtype)
    lead = getattr(adj, "feature_shape", None)
    if lead is not None:
        xs = xs.reshape(tuple(lead) + (x.shape[1],))
    return (xs, torch.from_numpy(np.ascontiguousarray(y[rows]).astype(np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(mask[rows]).astype(np.float32)).to(device))


def gather_rows(local: torch.Tensor, adj, n_global: int) -> torch.Tensor:
    """Every rank's rows of a flat per-node tensor ``[rows, ...]`` placed at
    their global ids, on every rank: ``[n_global, ...]``."""
    parts = comm.all_gather(local.contiguous())
    out = local.new_zeros((n_global,) + tuple(local.shape[1:]))
    rows_local = adj.node_rows()
    for r, part in enumerate(parts):
        out[_rows_of_rank(adj, r, rows_local)] = part.to(out.device)
    return out


def _rows_of_rank(adj, r: int, rows_local: torch.Tensor) -> torch.Tensor:
    """The global ids of rank ``r``'s rows (every rank's slab has the shape
    of this one's)."""
    if hasattr(adj, "fwd"):  # halo: contiguous blocks
        nd = adj.fwd.rows_per_shard
        return torch.arange(r * nd, (r + 1) * nd, device=rows_local.device)
    gd = adj.feature_shape[1]
    return rows_local + (r - adj.rank) * gd
