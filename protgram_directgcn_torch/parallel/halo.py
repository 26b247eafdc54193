"""Edge-partitioned propagation with an explicit ring halo exchange.

Port of protgram_directgcn_tpu/parallel/halo.py.  Nodes are block-
partitioned over the ranks (contiguous id ranges of ``rows_per_shard``
rows, the last rank's padded), and each propagation splits into

- a local part: edges whose source the rank owns;
- a halo part: edges whose source a peer owns, read from a receive buffer.

The buffer is the JAX package's ring plan (``_ring_plan``): at step k a rank
sends the rows its peer ``(rank + k) % D`` needs, padded to that step's
largest count over the ranks, and receives from ``(rank - k) % D``; the
buffer concatenates the steps' chunks.  Where the JAX package issues one
``ppermute`` a step, the port issues the whole ring as one
``all_to_all_single`` with split sizes and puts the chunks in step order,
within the partition's ``group`` (the ranks of one feature shard on a 2-D
rank grid; None: the world).

The host builds every rank's tables as the JAX package does (byte for byte,
stacked on a leading rank axis: ``build_halo_tables``) and each rank keeps
its own.  On the card the local and halo products run the ELL kernels
(``ops/ell_kernels.py``), the kernel picked by the table's rows as
``resident_supported`` picks it; on the CPU their plain version.  The
backward pass is the forward of the transpose partition, so no collective
needs autograd.  ``TriHaloAdj`` serves a layer's three matrices with one
exchange of their concatenated rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from protgram_directgcn_torch.ops import ell_kernels, spmm
from protgram_directgcn_torch.ops.spmm import _ell_one_sided
from protgram_directgcn_torch.parallel import distributed as comm


# ----------------------------------------------------------------------------
# Host-side tables (halo.py:45-168)
# ----------------------------------------------------------------------------


def _ring_plan(recv_sets, nd: int, num_shards: int):
    """(send_steps, buf_offset) of the ring exchange (halo.py:66-96).

    ``recv_sets[d][p]``: sorted global ids rank d needs from peer p.  At step
    k, rank q sends ``recv_sets[(q + k) % D][q]``, padded to the step's
    largest count over the ranks; ``buf_offset[k]`` is the step's first row
    in the receive buffer."""
    send_steps = []
    for k in range(1, num_shards):
        s_k = max(1, max(len(recv_sets[d][(d - k) % num_shards]) for d in range(num_shards)))
        step = np.zeros((num_shards, s_k), np.int32)
        for q in range(num_shards):
            need = recv_sets[(q + k) % num_shards][q]
            step[q, : len(need)] = (need - q * nd).astype(np.int32)
        send_steps.append(step)
    off, acc = {}, 0
    for k in range(1, num_shards):
        off[k] = acc
        acc += send_steps[k - 1].shape[1]
    return send_steps, off


def _split_edges(src, tgt, w, nd: int, num_shards: int):
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    w = np.asarray(w, np.float32)
    owner_t = np.minimum(tgt // nd, num_shards - 1)
    owner_s = np.minimum(src // nd, num_shards - 1)
    return src, tgt, w, owner_t, owner_s


def _stack_pad(mats):
    k = max(m.shape[1] for m in mats)
    return np.stack([np.pad(m, ((0, 0), (0, k - m.shape[1]))) for m in mats])


def _rank_tables(edges, recv_sets, buf_off, nd: int, num_shards: int):
    """Every rank's local and halo ELL tables, halo sources remapped into its
    receive buffer (halo.py:137-156), stacked on the rank axis."""
    src, tgt, w, owner_t, owner_s = edges
    l_idx, l_w, h_idx, h_w = [], [], [], []
    for d in range(num_shards):
        mask_d = owner_t == d
        s_d, t_d, w_d, o_d = src[mask_d], tgt[mask_d] - d * nd, w[mask_d], owner_s[mask_d]
        is_local = o_d == d
        hp, hg = o_d[~is_local], s_d[~is_local]
        buf = np.zeros(len(hg), np.int64)
        for p in range(num_shards):
            sel = hp == p
            if sel.any():
                pos = np.searchsorted(recv_sets[d][p], hg[sel])
                buf[sel] = buf_off[(d - p) % num_shards] + pos
        li, lw = _ell_one_sided(s_d[is_local] - d * nd, t_d[is_local], w_d[is_local], nd)
        hi, hw = _ell_one_sided(buf, t_d[~is_local], w_d[~is_local], nd)
        l_idx.append(li)
        l_w.append(lw)
        h_idx.append(hi)
        h_w.append(hw)
    return {"local_idx": _stack_pad(l_idx).astype(np.int32),
            "local_w": _stack_pad(l_w).astype(np.float32),
            "halo_idx": _stack_pad(h_idx).astype(np.int32),
            "halo_w": _stack_pad(h_w).astype(np.float32)}


def build_halo_tables(src, tgt, w, num_nodes: int, num_shards: int) -> Dict[str, object]:
    """Every rank's arrays of one matrix's partition, as
    ``build_halo_partition`` (halo.py:99-168) stacks them: ``local_idx``,
    ``local_w``, ``halo_idx``, ``halo_w`` ``[D, Nd, K]`` and ``send_steps``
    (step k at index k - 1: ``[D, s_k]``), with ``rows_per_shard`` and
    ``num_nodes``."""
    nd = -(-num_nodes // num_shards)
    edges = _split_edges(src, tgt, w, nd, num_shards)
    src_, _, _, owner_t, owner_s = edges
    recv_sets = [[np.empty(0, np.int64)] * num_shards for _ in range(num_shards)]
    for d in range(num_shards):
        mask_d = owner_t == d
        remote = owner_s[mask_d] != d
        peers, g_src = owner_s[mask_d][remote], src_[mask_d][remote]
        for p in range(num_shards):
            recv_sets[d][p] = np.unique(g_src[peers == p])
    send_steps, buf_off = _ring_plan(recv_sets, nd, num_shards)
    tables = _rank_tables(edges, recv_sets, buf_off, nd, num_shards)
    tables.update(send_steps=send_steps, rows_per_shard=nd, num_nodes=int(num_nodes))
    return tables


def build_tri_halo_tables(coos, num_nodes: int, num_shards: int) -> List[Dict[str, object]]:
    """The three matrices' tables over one shared ring plan, the union of
    their receive sets (``build_tri_halo_partition``, halo.py:372-451)."""
    nd = -(-num_nodes // num_shards)
    per_matrix = [_split_edges(s, t, w, nd, num_shards) for s, t, w in coos]
    union = [[np.empty(0, np.int64)] * num_shards for _ in range(num_shards)]
    for src, _, _, owner_t, owner_s in per_matrix:
        for d in range(num_shards):
            mask_d = owner_t == d
            remote = owner_s[mask_d] != d
            g_src, peers = src[mask_d][remote], owner_s[mask_d][remote]
            for p in range(num_shards):
                sel = peers == p
                if sel.any():
                    union[d][p] = np.union1d(union[d][p], g_src[sel])
    send_steps, buf_off = _ring_plan(union, nd, num_shards)
    out = []
    for edges in per_matrix:
        tables = _rank_tables(edges, union, buf_off, nd, num_shards)
        tables.update(send_steps=send_steps, rows_per_shard=nd, num_nodes=int(num_nodes))
        out.append(tables)
    return out


# ----------------------------------------------------------------------------
# A rank's partition and its exchange
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class HaloPartition:
    """One rank's share of a partitioned matrix."""

    local_idx: torch.Tensor  # [Nd, Kl] int32 local source rows
    local_w: torch.Tensor  # [Nd, Kl] f32
    halo_idx: torch.Tensor  # [Nd, Kh] int32 rows of the receive buffer
    halo_w: torch.Tensor  # [Nd, Kh] f32
    # Step k (index k - 1): the local rows sent to peer (rank + k) % D.
    send_steps: Tuple[torch.Tensor, ...]
    num_shards: int = 1
    num_nodes: int = 0
    rows_per_shard: int = 0
    rank: int = 0
    debug_checksums: bool = False
    group: Any = None  # the node shards' process group (None: the world)

    @classmethod
    def from_tables(cls, tables: Dict[str, object], rank: int, device,
                    debug_checksums: bool = False, group: Any = None) -> "HaloPartition":
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        steps = tables["send_steps"]
        return cls(local_idx=dev(tables["local_idx"][rank]), local_w=dev(tables["local_w"][rank]),
                   halo_idx=dev(tables["halo_idx"][rank]), halo_w=dev(tables["halo_w"][rank]),
                   send_steps=tuple(dev(s[rank].astype(np.int64)) for s in steps),
                   num_shards=len(steps) + 1, num_nodes=int(tables["num_nodes"]),
                   rows_per_shard=int(tables["rows_per_shard"]), rank=int(rank),
                   debug_checksums=bool(debug_checksums), group=group)


def _check_sums(expected: torch.Tensor, got: torch.Tensor) -> None:
    if not torch.allclose(expected.cpu(), got.cpu(), rtol=1e-5, atol=1e-6):
        raise RuntimeError("halo exchange checksum mismatch (corrupted boundary features): "
                           f"sent {expected.tolist()}, received {got.tolist()}")


def _ring_exchange(x_local: torch.Tensor, part: HaloPartition) -> torch.Tensor:
    """The receive buffer ``[sum_k s_k, F]`` in step order (a zero row
    where there are no peers), by one ``all_to_all_single`` (halo.py:190-213).
    Under ``debug_checksums`` each chunk's f32 sum travels with it and is
    checked on arrival."""
    d, rk = part.num_shards, part.rank
    if d == 1:
        return x_local.new_zeros((1, x_local.shape[1]))
    in_splits, out_splits = [0] * d, [0] * d
    chunks: List[torch.Tensor] = [x_local[:0]] * d
    for k, sidx in enumerate(part.send_steps, start=1):
        chunks[(rk + k) % d] = x_local[sidx]
        in_splits[(rk + k) % d] = out_splits[(rk - k) % d] = int(sidx.shape[0])
    recv = comm.all_to_all(torch.cat(chunks, dim=0), out_splits, in_splits, part.group)
    by_peer = torch.split(recv, out_splits, dim=0)
    steps = [by_peer[(rk - k) % d] for k in range(1, d)]
    if part.debug_checksums:
        peers = [p for p in range(d) if p != rk]
        ones = [0 if p == rk else 1 for p in range(d)]
        sent = torch.stack([chunks[p].float().sum() for p in peers])
        expect = comm.all_to_all(sent, ones, ones, part.group)  # what each peer sent here, summed there
        _check_sums(expect, torch.stack([by_peer[p].float().sum() for p in peers]))
    return torch.cat(steps, dim=0)


def _ell_block(idx: torch.Tensor, w: torch.Tensor, table: torch.Tensor,
               direction: str) -> torch.Tensor:
    """``out[i] = sum_k w[i, k] * table[idx[i, k]]`` in f32: an ELL kernel on
    the card (by the table's rows), the plain version on the CPU."""
    if spmm._on_card(table):
        kernel = (ell_kernels.ell_resident if ell_kernels.resident_supported(table.shape[0])
                  else ell_kernels.ell_hbm)
        return kernel(idx, w, table.float().contiguous(), direction)
    return ell_kernels.ell_plain(idx, w, table)


def halo_propagate(part: HaloPartition, x: torch.Tensor, direction: str = "fwd") -> torch.Tensor:
    """This rank's rows of the product (halo.py:216-244): the exchange, then
    the local product, then the halo product from the buffer."""
    recv = _ring_exchange(x, part)
    return (_ell_block(part.local_idx, part.local_w, x, direction)
            + _ell_block(part.halo_idx, part.halo_w, recv, direction))


def pad_node_features(x: np.ndarray, part) -> np.ndarray:
    """``[N, F]`` features padded to ``num_shards * rows_per_shard`` rows."""
    total = part.num_shards * part.rows_per_shard
    if x.shape[0] < total:
        x = np.pad(x, ((0, total - x.shape[0]), (0, 0)))
    return x


# ----------------------------------------------------------------------------
# Operators the model propagates through (halo.py:285-346, 454-541)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class HaloAdj:
    """A matrix's partition and its transpose's (the backward pass)."""

    fwd: HaloPartition
    bwd: HaloPartition
    route = "halo"

    @property
    def n_out(self) -> int:
        """This rank's rows."""
        return self.fwd.rows_per_shard

    @property
    def global_nodes(self) -> int:
        return self.fwd.num_shards * self.fwd.rows_per_shard

    def node_rows(self) -> torch.Tensor:
        """The global node ids of this rank's rows, in local order."""
        start = self.fwd.rank * self.fwd.rows_per_shard
        return torch.arange(start, start + self.fwd.rows_per_shard,
                            device=self.fwd.local_idx.device)


class _HaloProp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return halo_propagate(adj.fwd, x, "fwd")

    @staticmethod
    def backward(ctx, grad):
        return halo_propagate(ctx.adj.bwd, grad, "bwd"), None


def propagate(adj: HaloAdj, x: torch.Tensor) -> torch.Tensor:
    return _HaloProp.apply(x, adj)


def build_halo_adjacency(src, tgt, w, num_nodes: int, num_shards: int, rank: int, device,
                         debug_checksums: bool = False, group: Any = None) -> HaloAdj:
    return HaloAdj(
        fwd=HaloPartition.from_tables(build_halo_tables(src, tgt, w, num_nodes, num_shards),
                                      rank, device, debug_checksums, group),
        bwd=HaloPartition.from_tables(build_halo_tables(tgt, src, w, num_nodes, num_shards),
                                      rank, device, debug_checksums, group))


@dataclasses.dataclass
class TriHaloPartition:
    """Three matrices' partitions over one shared ring plan."""

    parts: Tuple[HaloPartition, HaloPartition, HaloPartition]


def tri_halo_propagate(tri: TriHaloPartition, xs: Sequence[torch.Tensor],
                       direction: str = "fwd") -> Tuple[torch.Tensor, ...]:
    """One exchange of the three inputs' concatenated rows, three products
    (halo.py:454-497)."""
    f = xs[0].shape[1]
    dtype = xs[0].dtype
    recv = _ring_exchange(torch.cat([x.to(dtype) for x in xs], dim=1), tri.parts[0])
    return tuple(
        _ell_block(p.local_idx, p.local_w, x, direction)
        + _ell_block(p.halo_idx, p.halo_w, recv[:, m * f:(m + 1) * f].contiguous(), direction)
        for m, (p, x) in enumerate(zip(tri.parts, xs)))


@dataclasses.dataclass
class TriHaloAdj:
    """A layer's three matrices with shared forward and backward exchanges
    (``propagate3`` runs it)."""

    fwd: TriHaloPartition
    bwd: TriHaloPartition


class _TriHaloProp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, x1, x2, adj):
        ctx.adj = adj
        return tri_halo_propagate(adj.fwd, (x0, x1, x2), "fwd")

    @staticmethod
    def backward(ctx, g0, g1, g2):
        return (*tri_halo_propagate(ctx.adj.bwd, (g0, g1, g2), "bwd"), None)


def propagate_tri(adj: TriHaloAdj, x_in, x_out, x_und):
    return _TriHaloProp.apply(x_in, x_out, x_und, adj)


def build_tri_halo_adjacency(coos, num_nodes: int, num_shards: int, rank: int, device,
                             debug_checksums: bool = False, group: Any = None) -> TriHaloAdj:
    """``coos``: three (src, tgt, w) triples for (𝒜_in, 𝒜_out, undirected)."""

    def tri(triples):
        return TriHaloPartition(parts=tuple(
            HaloPartition.from_tables(t, rank, device, debug_checksums, group)
            for t in build_tri_halo_tables(triples, num_nodes, num_shards)))

    return TriHaloAdj(fwd=tri(coos), bwd=tri([(t, s, w) for s, t, w in coos]))
