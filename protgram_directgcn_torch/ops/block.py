"""Block-structured propagation for n-gram transition graphs.

Port of protgram_directgcn_tpu/ops/block.py.  An edge ``u -> v`` of an
n-gram level joins u's (n-1)-gram suffix to v's (n-1)-gram prefix, so every
propagation matrix of the level (pattern inside union(A, Aᵀ, I)) factors
over the (n-1)-gram keys:

    M = diag(d) + Ppᵀ · blockdiag(Wf) · Sp + Spᵀ · blockdiag(Wb) · Pp

``Sp``/``Pp`` gather the nodes into suffix- and prefix-grouped layouts
``[G, R]`` / ``[G, C]`` (G keys, groups of at most the alphabet's size),
and ``Wf``/``Wb`` hold each key's dense block of the A pattern (suffix slot
r -> prefix slot c) and of the Aᵀ pattern.  A product is two row gathers,
two batched matmuls (``torch.einsum``) and two gathers back; the backward
applies the transposed factors (Mᵀ = diag(d) + Spᵀ·Wfᵀ·Pp + Ppᵀ·Wbᵀ·Sp)
to the cotangent, as the JAX package's custom VJP does (block.py:198-250).
The JAX package computes it with XLA einsums, outside Pallas: no kernel of
its own.  The builder is the JAX package's numpy code (the same arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch


class BlockStructureError(ValueError):
    """The edge set does not factor over the given node keys."""


class BankBudgetError(BlockStructureError):
    """A bank layout fits the structure but not the caller's device-memory
    budget (the hypercube builder's one failure another layout may pass)."""


@dataclasses.dataclass
class BlockNgramAdj:
    """Prefix/suffix-block factorisation of an n-gram propagation matrix."""

    d: torch.Tensor  # [N] f32 diagonal
    wf: torch.Tensor  # [G, C, R] f32: suffix slot r -> prefix slot c (A pattern)
    wb: torch.Tensor  # [G, R, C] f32: prefix slot c -> suffix slot r (Aᵀ pattern)
    sgrp: torch.Tensor  # [G, R] int32 node per suffix-grouped slot (pad -> 0)
    pgrp: torch.Tensor  # [G, C] int32 node per prefix-grouped slot (pad -> 0)
    pos_p: torch.Tensor  # [N] int32: node v sits at prefix-layout slot pos_p[v]
    pos_s: torch.Tensor  # [N] int32: node v sits at suffix-layout slot pos_s[v]

    @property
    def n_out(self) -> int:
        return self.d.shape[0]


def ngram_node_keys(vocab: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Prefix/suffix (n-1)-gram key ids for a sorted equal-length vocabulary
    (block.py:74-96): (pk, sk, num_keys), ids over the union of the keys in
    sorted key order.  1-grams get one all-pairs key."""
    vocab = np.asarray(vocab)
    n_nodes = len(vocab)
    if n_nodes == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
    n = len(str(vocab[0]))
    if n < 2:
        z = np.zeros(n_nodes, np.int64)
        return z, z, 1
    arr = vocab.astype(f"U{n}")
    chars = arr.view("U1").reshape(n_nodes, n)
    prefix = np.ascontiguousarray(chars[:, :-1]).view(f"U{n - 1}").reshape(n_nodes)
    suffix = np.ascontiguousarray(chars[:, 1:]).view(f"U{n - 1}").reshape(n_nodes)
    keys, inv = np.unique(np.concatenate([prefix, suffix]), return_inverse=True)
    return inv[:n_nodes], inv[n_nodes:], len(keys)


def _group_layout(key: np.ndarray, num_keys: int):
    """Node ids grouped by key: (grp [G, K] int32 pad -> 0, pos [N] int32,
    rank [N], group size K)."""
    n = len(key)
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    counts = np.bincount(key, minlength=num_keys)
    k = max(1, int(counts.max()) if num_keys else 1)
    starts = np.zeros(num_keys + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank_sorted = np.arange(n, dtype=np.int64) - starts[sorted_key]
    rank = np.empty(n, np.int64)
    rank[order] = rank_sorted
    grp = np.zeros((num_keys, k), np.int32)
    grp[key, rank] = np.arange(n, dtype=np.int32)
    pos = (key * k + rank).astype(np.int32)
    return grp, pos, rank, k


def build_block_ngram(src: np.ndarray, tgt: np.ndarray, val: np.ndarray, n_nodes: int,
                      pk: np.ndarray, sk: np.ndarray, num_keys: int, max_block: int = 64,
                      device: Union[str, torch.device] = "cuda") -> BlockNgramAdj:
    """Factor a coalesced COO matrix over prefix/suffix node keys
    (block.py:117-177).  Raises BlockStructureError where an off-diagonal
    edge fits neither the A pattern (sk[src] == pk[tgt]) nor the Aᵀ pattern
    (pk[src] == sk[tgt]), or a group exceeds ``max_block`` nodes."""
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    val = np.asarray(val, np.float32)
    pk = np.asarray(pk, np.int64)
    sk = np.asarray(sk, np.int64)

    pgrp, pos_p, prank, c_sz = _group_layout(pk, num_keys)
    sgrp, pos_s, srank, r_sz = _group_layout(sk, num_keys)
    if c_sz > max_block or r_sz > max_block:
        raise BlockStructureError(f"group sizes ({r_sz}, {c_sz}) exceed max_block={max_block}")

    d = np.zeros(n_nodes, np.float32)
    diag = src == tgt
    np.add.at(d, src[diag], val[diag])

    off = ~diag
    s, t, v = src[off], tgt[off], val[off]
    fwd = sk[s] == pk[t]
    bwd = ~fwd & (pk[s] == sk[t])
    leftover = int((~fwd & ~bwd).sum())
    if leftover:
        raise BlockStructureError(f"{leftover} edges fit neither the A nor the Aᵀ n-gram pattern")

    wf = np.zeros((num_keys, c_sz, r_sz), np.float32)
    wb = np.zeros((num_keys, r_sz, c_sz), np.float32)
    # Coalesced COO and injective edge -> slot maps: plain assignment.
    wf[sk[s[fwd]], prank[t[fwd]], srank[s[fwd]]] = v[fwd]
    wb[pk[s[bwd]], srank[t[bwd]], prank[s[bwd]]] = v[bwd]

    def dev(a):
        return torch.from_numpy(a).to(device)

    return BlockNgramAdj(d=dev(d), wf=dev(wf), wb=dev(wb), sgrp=dev(sgrp), pgrp=dev(pgrp),
                         pos_p=dev(pos_p), pos_s=dev(pos_s))


def block_gather_rows(adj: BlockNgramAdj) -> int:
    """Randomly gathered rows per propagation (the format choice's model)."""
    g, r = adj.sgrp.shape
    return g * r + adj.pos_s.shape[0]


def _block_apply(adj: BlockNgramAdj, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """``M x``, or ``Mᵀ x`` with ``transpose``, in f32 (the JAX package's
    ``preferred_element_type=float32``)."""
    f = x.shape[-1]
    g, r = adj.sgrp.shape
    c = adj.pgrp.shape[1]
    x = x.float()
    xg_s = x[adj.sgrp.reshape(-1).long()].reshape(g, r, f)
    xg_p = x[adj.pgrp.reshape(-1).long()].reshape(g, c, f)
    if not transpose:
        y_p = torch.einsum("gcr,grf->gcf", adj.wf, xg_s)  # A pattern: suffix -> prefix
        y_s = torch.einsum("grc,gcf->grf", adj.wb, xg_p)  # Aᵀ pattern: prefix -> suffix
    else:
        y_s = torch.einsum("gcr,gcf->grf", adj.wf, xg_p)  # Wfᵀ
        y_p = torch.einsum("grc,grf->gcf", adj.wb, xg_s)  # Wbᵀ
    out = adj.d[:, None] * x
    out = out + y_p.reshape(g * c, f)[adj.pos_p.long()]
    return out + y_s.reshape(g * r, f)[adj.pos_s.long()]


class _PropagateBlock(torch.autograd.Function):
    """``M x`` whose backward applies the transposed factors to the
    cotangent (block.py:198-250); the operator gets no gradient."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj, ctx.x_dtype = adj, x.dtype
        return _block_apply(adj, x)

    @staticmethod
    def backward(ctx, grad):
        return _block_apply(ctx.adj, grad, transpose=True).to(ctx.x_dtype), None


def propagate_block(adj: BlockNgramAdj, x: torch.Tensor) -> torch.Tensor:
    """out[i] = sum over edges (j -> i) of w * x[j], by the block factors."""
    return _PropagateBlock.apply(x, adj)
