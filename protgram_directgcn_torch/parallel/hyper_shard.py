"""The hypercube format sharded along its key axis.

Port of protgram_directgcn_tpu/parallel/hyper_shard.py.  One propagation of
rg features ``[A, G, F]`` is K1 (by suffix key g), the z relayout (gc to rg),
then K2 (by key g, reading the gc view of x).  Sharding G over the ranks
(``Gd = ceil(G / D)`` keys each, the last rank's padded) keeps both kernels
local; the two relayouts become regular all-to-alls.  A rank holds
``x [A, Gd, F]`` and the bank slabs ``[A, Gd, A]``; one propagation is

    x exchange (the rank's contiguous gc block of x)  ->  K1 on the slab
    ->  z exchange (gc block back to rg)  ->  K2

with the exchange tables of the JAX package (``build_hyper_shard_tables``,
byte for byte, depending only on (A, G, D)).  On the card K1 is
``hyper_kernels.k1`` on the slab as it is; K2 takes the received gc block
through its own pointer (``hyper_kernels.k2(..., x_gc=...)``), so its
diagonal term still reads the rank's own rg rows.  The backward pass is the
same call with the banks swapped; the graph gets no gradient.
``HyperShardTri`` carries a layer's three matrices' rows in one exchange a
relayout.

``PROTGRAM_HS_WIRE=bf16`` puts f32 rows on a bf16 wire; ``PROTGRAM_HS_NOCOMM=1``
replaces each exchange by the identity (wrong data, the same local work), so
that a scaling harness can time the compute alone (hyper_shard.py:263-298).
Both are read once, when ``build_hyper_shard`` builds a rank's operator, and
kept on it; the second is logged as a warning there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from protgram_directgcn_torch.ops import hyper_kernels
from protgram_directgcn_torch.ops.block import BlockStructureError
from protgram_directgcn_torch.parallel import distributed as comm
from protgram_directgcn_torch.utils.io import logger


# ----------------------------------------------------------------------------
# Host-side tables and slabs (hyper_shard.py:94-229)
# ----------------------------------------------------------------------------


def build_hyper_shard_tables(a: int, g: int, num_shards: int) -> Dict[str, np.ndarray]:
    """Every rank's exchange tables (``build_hyper_shard_tables``,
    hyper_shard.py:94-146): ``send_gc [D, D, S1]`` (local flat rows r*Gd+gl
    sent to each peer), ``asm_gc [D, Gd*A]`` (gc block rows from the
    ``[D*S1 + 1]`` receive buffer, the last row zero), ``send_rg [D, D, S2]``
    and ``asm_rg [D, A*Gd]`` the same for the z exchange."""
    d_count = num_shards
    gd = -(-g // d_count)
    m = np.arange(a * g, dtype=np.int64)
    rg_owner = (m % g) // gd
    gc_owner = np.minimum(m // (gd * a), d_count - 1)
    r = m // g
    local_flat = r * gd + (m % g) - rg_owner * gd
    block_pos = m - gc_owner * (gd * a)

    def tables(src_owner, dst_owner, send_pos, asm_pos, width):
        lists = [[None] * d_count for _ in range(d_count)]
        for dst in range(d_count):
            in_dst = dst_owner == dst
            for src in range(d_count):
                sel = in_dst & (src_owner == src)
                lists[src][dst] = (send_pos[sel], asm_pos[sel])
        s = max(1, max(len(v[0]) for row in lists for v in row))
        send = np.zeros((d_count, d_count, s), np.int32)
        asm = np.full((d_count, width), d_count * s, np.int32)
        for src in range(d_count):
            for dst in range(d_count):
                rows, pos = lists[src][dst]
                send[src, dst, : len(rows)] = rows
                asm[dst, pos] = (src * s + np.arange(len(rows))).astype(np.int32)
        return send, asm

    send_gc, asm_gc = tables(rg_owner, gc_owner, local_flat, block_pos, gd * a)
    send_rg, asm_rg = tables(gc_owner, rg_owner, block_pos, local_flat, a * gd)
    return {"send_gc": send_gc, "asm_gc": asm_gc, "send_rg": send_rg, "asm_rg": asm_rg}


def build_hyper_shard_slabs(src, tgt, val, codes, alphabet_size: int,
                            num_shards: int) -> Dict[str, np.ndarray]:
    """Every rank's slabs of one matrix, f32 (``build_hyper_shard``,
    hyper_shard.py:148-229): ``d [D, A, Gd]``, ``wf``/``wb`` ``[D, A, Gd, A]``
    and ``node_map [N_real]``, the padded flat id ``r * (D*Gd) + g`` of each
    real node.  Raises BlockStructureError as ``build_hypercube`` does."""
    codes = np.asarray(codes, np.int64)
    _, n = codes.shape
    a = int(alphabet_size)
    if n < 2:
        raise BlockStructureError("hypercube format needs n >= 2")
    g = a ** (n - 1)
    d_count = int(num_shards)
    gd = -(-g // d_count)
    gp = gd * d_count
    hyper = codes @ (a ** np.arange(n - 1, -1, -1, dtype=np.int64))
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    val = np.asarray(val, np.float32)
    pk, sk = hyper // a, hyper % g
    first, last = codes[:, 0], codes[:, -1]
    diag = src == tgt
    d_full = np.zeros(a * g, np.float32)
    np.add.at(d_full, hyper[src[diag]], val[diag])
    s, t, v = src[~diag], tgt[~diag], val[~diag]
    fwd = sk[s] == pk[t]
    bwd = ~fwd & (pk[s] == sk[t])
    leftover = int((~fwd & ~bwd).sum())
    if leftover:
        raise BlockStructureError(f"{leftover} edges fit neither the A nor the Aᵀ n-gram pattern")

    def bank(r_ids, g_ids, c_ids, vals):
        flat = np.zeros(a * gp * a, np.float32)
        np.add.at(flat, (r_ids * gp + g_ids) * a + c_ids, vals)
        return flat.reshape(a, d_count, gd, a).transpose(1, 0, 2, 3)

    sf, tf, vf = s[fwd], t[fwd], v[fwd]
    sb, tb, vb = s[bwd], t[bwd], v[bwd]
    d_slab = np.zeros((a, gp), np.float32)
    d_slab[:, :g] = d_full.reshape(a, g)
    return {"d": d_slab.reshape(a, d_count, gd).transpose(1, 0, 2),
            "wf": bank(first[sf], sk[sf], last[tf], vf),
            "wb": bank(first[tb], pk[sb], last[sb], vb),
            "node_map": (hyper // g) * gp + (hyper % g)}


@dataclasses.dataclass
class HyperShardTables:
    """One rank's exchange tables, flattened for one gather each."""

    send_gc: torch.Tensor  # [D*S1] int64 local flat rows, peer-major
    asm_gc: torch.Tensor  # [Gd*A] int64 rows of [D*S1 + 1]
    send_rg: torch.Tensor  # [D*S2]
    asm_rg: torch.Tensor  # [A*Gd]

    @classmethod
    def for_rank(cls, tables: Dict[str, np.ndarray], rank: int, device) -> "HyperShardTables":
        return cls(**{k: torch.from_numpy(v[rank].reshape(-1).astype(np.int64)).to(device)
                      for k, v in tables.items()})


@dataclasses.dataclass
class HyperShardAdj:
    """One rank's slabs of a matrix in the key-sharded hypercube format."""

    d: torch.Tensor  # [A, Gd] f32
    wf: torch.Tensor  # [A, Gd, A] r-major A-pattern slab
    wb: torch.Tensor  # [A, Gd, A] r-major Aᵀ-pattern slab
    tables: HyperShardTables
    node_map: np.ndarray  # [N_real] padded flat id of each real node
    num_shards: int = 1
    rank: int = 0
    wire_bf16: bool = False  # PROTGRAM_HS_WIRE=bf16: f32 rows cross as bf16
    nocomm: bool = False  # PROTGRAM_HS_NOCOMM=1: every exchange is the identity
    group: Any = None  # the node shards' process group (None: the world)
    route = "hyper_shard"

    @property
    def alphabet(self) -> int:
        return self.d.shape[0]

    @property
    def feature_shape(self) -> Tuple[int, int]:
        """This rank's rg feature slab [A, Gd]."""
        return (self.d.shape[0], self.d.shape[1])

    @property
    def n_out(self) -> int:
        """This rank's rows."""
        return self.d.shape[0] * self.d.shape[1]

    @property
    def g_padded(self) -> int:
        return self.num_shards * self.d.shape[1]

    @property
    def global_nodes(self) -> int:
        return self.alphabet * self.g_padded

    def node_rows(self) -> torch.Tensor:
        """The padded flat ids ``r * (D*Gd) + rank*Gd + gl`` of this rank's
        rows, in local (r, gl) order."""
        a, gd = self.feature_shape
        r = torch.arange(a, device=self.d.device)[:, None]
        gl = torch.arange(gd, device=self.d.device)[None, :]
        return (r * self.g_padded + self.rank * gd + gl).reshape(-1)


def build_hyper_shard(src, tgt, val, codes, alphabet_size: int, num_shards: int, rank: int,
                      device, weights_dtype: torch.dtype = torch.float32,
                      tables: Optional[Dict[str, np.ndarray]] = None,
                      group: Any = None) -> HyperShardAdj:
    """This rank's ``HyperShardAdj`` of a coalesced COO matrix; ``rank``
    is its place among the ``num_shards`` key shards of ``group``."""
    slabs = build_hyper_shard_slabs(src, tgt, val, codes, alphabet_size, num_shards)
    a = int(alphabet_size)
    if tables is None:
        tables = build_hyper_shard_tables(a, a ** (np.asarray(codes).shape[1] - 1), num_shards)

    def dev(arr, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)

    nocomm = os.environ.get("PROTGRAM_HS_NOCOMM") == "1"
    if nocomm:
        logger.warning("PROTGRAM_HS_NOCOMM=1: every hypercube shard exchange is the identity "
                       "(timing only; the products are wrong)")
    return HyperShardAdj(d=dev(slabs["d"][rank]), wf=dev(slabs["wf"][rank], weights_dtype),
                         wb=dev(slabs["wb"][rank], weights_dtype),
                         tables=HyperShardTables.for_rank(tables, rank, device),
                         node_map=slabs["node_map"], num_shards=int(num_shards), rank=int(rank),
                         wire_bf16=os.environ.get("PROTGRAM_HS_WIRE", "auto") == "bf16",
                         nocomm=nocomm, group=group)


# ----------------------------------------------------------------------------
# Exchanges and the local pair (hyper_shard.py:231-314)
# ----------------------------------------------------------------------------


def _exchange(send_idx: torch.Tensor, asm_idx: torch.Tensor,
              rows: Sequence[torch.Tensor], adj: HyperShardAdj) -> Tuple[torch.Tensor, ...]:
    """Gather each feature set's rows for every peer, send them in one
    all_to_all, and assemble each set's destination rows (missing rows read
    the zero row past the buffer's end).  ``adj`` carries the shard count and
    the wire options."""
    num_shards = adj.num_shards
    s = send_idx.shape[0] // num_shards
    f = rows[0].shape[1]
    wire = torch.bfloat16 if adj.wire_bf16 and rows[0].dtype == torch.float32 else rows[0].dtype
    send = torch.cat([r[send_idx].to(wire).view(num_shards, s, f) for r in rows], dim=1)
    flat_send = send.view(-1, f)
    recv = (flat_send if adj.nocomm else comm.all_to_all(flat_send, group=adj.group)).view(
        num_shards, len(rows) * s, f)
    outs = []
    for i, r in enumerate(rows):
        flat = torch.cat([recv[:, i * s:(i + 1) * s].reshape(num_shards * s, f),
                          recv.new_zeros((1, f))])
        outs.append(flat[asm_idx].to(r.dtype))
    return tuple(outs)


def _shard_apply(adjs: Sequence[HyperShardAdj], xs: Sequence[torch.Tensor], transpose: bool,
                 scale: float = 1.0, shift: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """``scale * (M x) + shift`` on this rank's slab for each (matrix, input)
    pair, their rows sharing one exchange a relayout."""
    direction = "bwd" if transpose else "fwd"
    t = adjs[0].tables
    xs = [x.contiguous() for x in xs]
    a, gd, f = xs[0].shape
    x_gc = _exchange(t.send_gc, t.asm_gc, [x.view(a * gd, f) for x in xs], adjs[0])
    zs = [hyper_kernels.k1(adj.wb if transpose else adj.wf, x, direction)
          for adj, x in zip(adjs, xs)]
    z_rg = _exchange(t.send_rg, t.asm_rg, [z.view(gd * a, f) for z in zs], adjs[0])
    return tuple(
        hyper_kernels.k2(adj.d, adj.wf if transpose else adj.wb, z.view(a, gd, f), x, scale,
                         shift, direction, x_gc=gc.view(gd, a, f))
        for adj, x, z, gc in zip(adjs, xs, z_rg, x_gc))


class _HyperShardProp(torch.autograd.Function):
    """``scale * (M x) + shift``; the backward is ``scale * Mᵀ g``
    (hyper_shard.py:363-387)."""

    @staticmethod
    def forward(ctx, x, adj, scale, shift):
        ctx.adj, ctx.scale = adj, scale
        return _shard_apply([adj], [x], False, scale, shift)[0]

    @staticmethod
    def backward(ctx, grad):
        return _shard_apply([ctx.adj], [grad], True, ctx.scale, 0.0)[0], None, None, None


def propagate(adj: HyperShardAdj, x: torch.Tensor, scale: float = 1.0,
              shift: float = 0.0) -> torch.Tensor:
    """This rank's rows of ``scale * (M x) + shift``; ``x`` is the rank's
    flat ``[A*Gd, F]`` or rg ``[A, Gd, F]`` rows, and the output has its
    layout."""
    a, gd = adj.feature_shape
    flat_in = x.dim() == 2
    x_rg = x.reshape(a, gd, x.shape[-1]) if flat_in else x
    out = _HyperShardProp.apply(x_rg, adj, float(scale), float(shift))
    return out.reshape(a * gd, -1) if flat_in else out


@dataclasses.dataclass
class HyperShardTri:
    """A layer's three matrices (in, out, und) with one exchange a
    relayout for all three (hyper_shard.py:403-540)."""

    adjs: Tuple[HyperShardAdj, HyperShardAdj, HyperShardAdj]


class _HyperShardTriProp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, x1, x2, tri):
        ctx.tri = tri
        return _shard_apply(tri.adjs, (x0, x1, x2), False)

    @staticmethod
    def backward(ctx, g0, g1, g2):
        return (*_shard_apply(ctx.tri.adjs, (g0, g1, g2), True), None)


def propagate_tri(tri: HyperShardTri, x_in, x_out, x_und):
    a, gd = tri.adjs[0].feature_shape
    flat_in = x_in.dim() == 2
    xs = [x.reshape(a, gd, x.shape[-1]) if flat_in else x for x in (x_in, x_out, x_und)]
    outs = _HyperShardTriProp.apply(*xs, tri)
    return tuple(o.reshape(a * gd, -1) for o in outs) if flat_in else outs


def shard_hyper_features(x: torch.Tensor, adj: HyperShardAdj) -> torch.Tensor:
    """This rank's key slab ``[A, Gd, F]`` of rg features ``[A, D*Gd, F]``."""
    gd = adj.feature_shape[1]
    return x[:, adj.rank * gd:(adj.rank + 1) * gd].contiguous()
