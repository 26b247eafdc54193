"""Propagation operators: adjacency formats, their builders and the dispatch.

Port of protgram_directgcn_tpu/ops/spmm.py:36-721.  ``propagate(adj,
x)[i] = sum over edges (j -> i) of w * x[j]`` (reference:
protgram_directgcn.py:100-140, PyG aggr='add').

- ``DenseAdj``: Aᵀ stored dense, one ``torch.matmul``;
- ``EllAdj``: padded neighbour lists ``[N, K]`` in both orientations;
- ``BucketedEllAdj``: degree-bucketed ELL for degree-skewed graphs;
- ``CooAdj``: target-sorted COO and a segment sum (``index_add``);
- ``BlockNgramAdj``: the prefix/suffix block factors (ops/block.py);
- ``HypercubeAdj``: the gather-free K1/K2 pair (ops/hypercube.py).

Under bf16 compute a dense operator is stored bf16 and the edge-list
formats keep f32 weights; all of them return f32 (the JAX package's
``preferred_element_type=float32`` for dense, spmm.py:597-600, and its ELL
kernels' f32 cast of x, pallas_spmm.py:83, :220).  The hypercube returns
the carry's type.  The builders are the JAX package's numpy code and give
the same arrays byte for byte.  Every format's backward reads its stored
transpose orientation (the block format its transposed factors; no
scatter over the forward's indices).  The graph gets no gradient unless
``propagate(..., edge_grads=True)`` asks for the SDDMM edge-weight
gradients (below); a dense operator is differentiated by autograd.

The route is the device's: on the card both ELL formats run the CUDA ELL
kernels (ops/ell_kernels.py), on the CPU their plain version.  The JAX
package's ``use_pallas`` has no counterpart: off its Pallas path it leaves
the product to XLA, and the kernels compute the same function.  With
``edge_grads`` the product and ``dx`` still run through the kernels on the
card, and the SDDMM runs beside them as plain torch, as the JAX package
computes it outside Pallas (spmm.py:602).

The distributed operators of ``parallel/`` (``HaloAdj``, ``TriHaloAdj``,
``HyperShardAdj``, ``HyperShardTri``, ``RowShardEllAdj``, ``RowShardTri``)
dispatch from here as in the JAX
package (spmm.py:621-630, :677-685, :716-720).
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from protgram_directgcn_torch.ops import block, ell_kernels
from protgram_directgcn_torch.ops.block import BlockNgramAdj

Device = Union[str, torch.device]

# ----------------------------------------------------------------------------
# SDDMM: optional gradients w.r.t. adjacency weights (spmm.py:36-86)
# ----------------------------------------------------------------------------

# Off by default: the reference never learns edge weights (its adjacency is a
# preprocessed constant, graph_utils.py:198-287).  ``propagate(adj, x,
# edge_grads=True)`` opts in: dw for the edge-list formats is the sampled
# dense-dense product ``dw[slot] = <g[tgt], x[src]>`` (padding slots, w == 0,
# get zero), the hypercube's the per-key [A x A] contractions
# (ops/hypercube.py).  The transpose-orientation weights get zeros: the
# forward product does not read them.
_EDGE_GRADS = False


@contextlib.contextmanager
def edge_gradients(enable: bool = True):
    """DEPRECATED shim (spmm.py:52-82): pass ``edge_grads=True`` to
    :func:`propagate` / :func:`propagate3` instead.  Sets the default that
    ``propagate`` takes when its ``edge_grads`` is None; warns on entry."""
    warnings.warn(
        "ops.spmm.edge_gradients() is deprecated: pass edge_grads=True to "
        "propagate()/propagate3()", DeprecationWarning, stacklevel=3)
    global _EDGE_GRADS
    prev = _EDGE_GRADS
    _EDGE_GRADS = bool(enable)
    try:
        yield
    finally:
        _EDGE_GRADS = prev


def edge_gradients_enabled() -> bool:
    return _EDGE_GRADS


# ----------------------------------------------------------------------------
# Device adjacency formats
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class DenseAdj:
    """Dense Aᵀ (out[i] = sum_j at[i, j] x[j])."""

    at: torch.Tensor  # [n_out, n_in]

    @property
    def n_out(self) -> int:
        return self.at.shape[0]


@dataclasses.dataclass
class EllAdj:
    """Padded neighbour lists, both orientations: ``idx[i, k]`` is the k-th
    source feeding target i with weight ``w[i, k]`` (padding slots have
    w == 0 and idx == 0); ``idx_t/w_t`` list the targets of each source."""

    idx: torch.Tensor  # [n_out, K] int32
    w: torch.Tensor  # [n_out, K] f32
    idx_t: torch.Tensor  # [n_in, Kt] int32
    w_t: torch.Tensor  # [n_in, Kt] f32

    @property
    def n_out(self) -> int:
        return self.idx.shape[0]


@dataclasses.dataclass
class CooAdj:
    """Sorted-by-target COO with the transpose orientation for backward."""

    src: torch.Tensor  # [nnz] int32
    tgt: torch.Tensor  # [nnz] int32 (sorted ascending)
    w: torch.Tensor  # [nnz] f32
    src_t: torch.Tensor  # transpose orientation, sorted by its own target (=src)
    tgt_t: torch.Tensor
    w_t: torch.Tensor
    n_out: int = 0
    n_in: int = 0


@dataclasses.dataclass
class BucketedEllAdj:
    """Degree-bucketed ELL: rows grouped by degree into per-bucket ELL
    tables; ``inv_perm`` maps the concatenated bucket output back to node
    order.  Both orientations are bucketed independently."""

    idx: Tuple[torch.Tensor, ...]  # per-bucket [rows_b, K_b] int32 source ids
    w: Tuple[torch.Tensor, ...]  # per-bucket [rows_b, K_b] f32
    inv_perm: torch.Tensor  # [n_out] int32: out = concat(buckets)[inv_perm]
    idx_t: Tuple[torch.Tensor, ...]
    w_t: Tuple[torch.Tensor, ...]
    inv_perm_t: torch.Tensor

    @property
    def n_out(self) -> int:
        return self.inv_perm.shape[0]


# ----------------------------------------------------------------------------
# Host-side builders (spmm.py:164-380, byte-exact)
# ----------------------------------------------------------------------------


def _dev(a: np.ndarray, device: Device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _ell_one_sided(src: np.ndarray, tgt: np.ndarray, w: np.ndarray, n_out: int,
                   pad_multiple: int = 4):
    """Group (src, w) by tgt into padded [n_out, K] arrays."""
    src = np.asarray(src, dtype=np.int64)
    tgt = np.asarray(tgt, dtype=np.int64)
    w = np.asarray(w, dtype=np.float32)
    deg = np.bincount(tgt, minlength=n_out) if len(tgt) else np.zeros(n_out, dtype=np.int64)
    k = max(1, int(deg.max()) if len(deg) else 1)
    k = _round_up(k, pad_multiple)
    idx = np.zeros((n_out, k), dtype=np.int32)
    wm = np.zeros((n_out, k), dtype=np.float32)
    if len(tgt):
        order = np.argsort(tgt, kind="stable")
        ts, ss, ws = tgt[order], src[order], w[order]
        starts = np.zeros(n_out + 1, dtype=np.int64)
        np.cumsum(deg, out=starts[1:])
        offsets = np.arange(len(ts), dtype=np.int64) - starts[ts]
        idx[ts, offsets] = ss.astype(np.int32)
        wm[ts, offsets] = ws
    return idx, wm


def build_ell(src: np.ndarray, tgt: np.ndarray, w: np.ndarray, n_out: int,
              n_in: Optional[int] = None, device: Device = "cuda") -> EllAdj:
    n_in = n_out if n_in is None else n_in
    idx, wm = _ell_one_sided(src, tgt, w, n_out)
    idx_t, wm_t = _ell_one_sided(tgt, src, w, n_in)
    return EllAdj(idx=_dev(idx, device), w=_dev(wm, device), idx_t=_dev(idx_t, device),
                  w_t=_dev(wm_t, device))


def build_dense(src: np.ndarray, tgt: np.ndarray, w: np.ndarray, n_out: int,
                n_in: Optional[int] = None, dtype: torch.dtype = torch.float32,
                device: Device = "cuda") -> DenseAdj:
    n_in = n_out if n_in is None else n_in
    at = np.zeros((n_out, n_in), dtype=np.float32)
    if len(src):
        np.add.at(at, (np.asarray(tgt, np.int64), np.asarray(src, np.int64)),
                  np.asarray(w, np.float32))
    return DenseAdj(at=torch.from_numpy(at).to(device=device, dtype=dtype))


# Few buckets (spmm.py:215-217).
_BUCKET_KS = (8, 16, 64)


def _bucketed_one_sided(src, tgt, w, n_out, device: Device):
    """Group rows (targets) by degree bucket; returns (idx_list, w_list, inv_perm)."""
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    w = np.asarray(w, np.float32)
    deg = np.bincount(tgt, minlength=n_out) if len(tgt) else np.zeros(n_out, np.int64)
    order = np.argsort(deg, kind="stable")
    inv = np.empty(n_out, np.int64)
    inv[order] = np.arange(n_out)
    tgt_p = inv[tgt]
    sorted_deg = deg[order]
    bounds = []
    start = 0
    for kb in _BUCKET_KS:
        end = int(np.searchsorted(sorted_deg, kb, side="right"))
        if end > start:
            bounds.append((start, end))
        start = end
        if start >= n_out:
            break
    if start < n_out:
        bounds.append((start, n_out))
    if not bounds:
        bounds = [(0, n_out)]
    idx_list, w_list = [], []
    for s_, e_ in bounds:
        m = (tgt_p >= s_) & (tgt_p < e_)
        bi, bw = _ell_one_sided(src[m], tgt_p[m] - s_, w[m], e_ - s_)
        idx_list.append(_dev(bi, device))
        w_list.append(_dev(bw, device))
    return tuple(idx_list), tuple(w_list), _dev(inv.astype(np.int32), device)


def build_bucketed_ell(src, tgt, w, n_out: int, n_in: Optional[int] = None,
                       device: Device = "cuda") -> BucketedEllAdj:
    n_in = n_out if n_in is None else n_in
    idx, wm, inv = _bucketed_one_sided(src, tgt, w, n_out, device)
    idx_t, wm_t, inv_t = _bucketed_one_sided(tgt, src, w, n_in, device)
    return BucketedEllAdj(idx=idx, w=wm, inv_perm=inv, idx_t=idx_t, w_t=wm_t, inv_perm_t=inv_t)


def build_coo(src: np.ndarray, tgt: np.ndarray, w: np.ndarray, n_out: int,
              n_in: Optional[int] = None, device: Device = "cuda") -> CooAdj:
    n_in = n_out if n_in is None else n_in
    src = np.asarray(src, np.int32)
    tgt = np.asarray(tgt, np.int32)
    w = np.asarray(w, np.float32)
    order = np.argsort(tgt, kind="stable")
    order_t = np.argsort(src, kind="stable")
    return CooAdj(
        src=_dev(src[order], device),
        tgt=_dev(tgt[order], device),
        w=_dev(w[order], device),
        src_t=_dev(tgt[order_t], device),
        tgt_t=_dev(src[order_t], device),
        w_t=_dev(w[order_t], device),
        n_out=int(n_out),
        n_in=int(n_in),
    )


def choose_format(n_out: int, n_in: int, nnz: int, feat_dim: int = 128) -> str:
    """Pick the adjacency format minimising bytes moved per propagation
    (spmm.py:281-298): dense moves ~2·n_out·n_in bytes, ELL ~4·F·nnz·1.25."""
    if nnz == 0:
        return "dense" if n_out * n_in <= 4_000_000 else "coo"
    deg = float(nnz) / max(n_out, 1)
    dense_bytes = 2.0 * n_out * n_in
    ell_pad_factor = 1.25  # typical padding for bounded-degree n-gram graphs
    ell_bytes = 4.0 * feat_dim * nnz * ell_pad_factor
    if dense_bytes <= ell_bytes and n_out * n_in * 4 <= 2 << 30:
        return "dense"
    return "ell" if deg >= 1.0 else "coo"


def build_adjacency(
    src: np.ndarray,
    tgt: np.ndarray,
    w: np.ndarray,
    n_out: int,
    n_in: Optional[int] = None,
    mode: str = "auto",
    feat_dim: int = 128,
    dtype: torch.dtype = torch.float32,
    node_keys: Optional[Tuple[np.ndarray, np.ndarray, int]] = None,
    device: Device = "cuda",
) -> Union[DenseAdj, EllAdj, BucketedEllAdj, CooAdj, BlockNgramAdj]:
    """The device adjacency in the requested or auto-selected format, by the
    JAX package's rule (spmm.py:301-381).  ``node_keys`` (prefix key, suffix
    key, key count) unlocks the block format for a square matrix: taken
    under "auto" where its gathered rows beat the edge formats' and the
    edges factor over the keys.  The hypercube format is built by
    ``NgramGraph.to_device``."""
    n_in = n_out if n_in is None else n_in
    if mode in ("auto", "block") and node_keys is not None and n_out == n_in and len(src):
        pk, sk, num_keys = node_keys
        counts_s = np.bincount(np.asarray(sk, np.int64), minlength=num_keys)
        r_est = int(counts_s.max()) if len(counts_s) else 1
        block_rows = num_keys * r_est + n_out  # random rows per pass
        worthwhile = block_rows < 0.9 * len(src) and r_est <= 64
        if mode == "block" or (worthwhile
                               and choose_format(n_out, n_in, len(src), feat_dim) != "dense"):
            try:
                return block.build_block_ngram(src, tgt, w, n_out, pk, sk, num_keys,
                                               device=device)
            except block.BlockStructureError:
                if mode == "block":
                    raise
    if mode == "auto":
        mode = choose_format(n_out, n_in, len(src), feat_dim)
        if mode == "ell" and len(tgt):
            # Degree skew: single-K ELL wastes padded slots, use degree buckets.
            deg = np.bincount(np.asarray(tgt, np.int64), minlength=n_out)
            deg_t = np.bincount(np.asarray(src, np.int64), minlength=n_in)
            kmax = max(int(deg.max()), int(deg_t.max()))
            if kmax * max(n_out, n_in) > 2 * len(src):
                mode = "bucketed"
    if mode == "dense":
        return build_dense(src, tgt, w, n_out, n_in, dtype=dtype, device=device)
    if mode in ("ell", "pallas"):
        return build_ell(src, tgt, w, n_out, n_in, device=device)
    if mode == "bucketed":
        return build_bucketed_ell(src, tgt, w, n_out, n_in, device=device)
    if mode == "coo":
        return build_coo(src, tgt, w, n_out, n_in, device=device)
    raise ValueError(f"Unknown adjacency mode: {mode}")


# ----------------------------------------------------------------------------
# Propagation
# ----------------------------------------------------------------------------


class _LinearOp(torch.autograd.Function):
    """``y = M x`` for a constant operator given as two functions, ``M`` and
    ``Mᵀ``: the backward applies ``Mᵀ`` to the cotangent."""

    @staticmethod
    def forward(ctx, x, apply: Callable, apply_t: Callable):
        ctx.apply_t = apply_t
        return apply(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.apply_t(grad), None, None


def _dense_apply(at: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``at @ x`` with x in the operator's type and an f32 result, as the JAX
    package's ``preferred_element_type=float32`` (spmm.py:597-600): a bf16
    operator's products are summed and returned in f32."""
    if at.dtype == torch.float32:
        return at @ x.to(torch.float32)
    return at.float() @ x.to(at.dtype).float()


def _bucketed_apply(idx_tuple, w_tuple, inv_perm, x, kernel=None, direction="fwd"):
    """Each bucket's ELL product, in node order.  ``kernel``: one of the ELL
    kernel wrappers, else the plain version."""
    if kernel is None:
        outs = [ell_kernels.ell_plain(i, wv, x) for i, wv in zip(idx_tuple, w_tuple)]
    else:
        xc = x.float().contiguous()
        outs = [kernel(i, wv, xc, direction) for i, wv in zip(idx_tuple, w_tuple)]
    return torch.cat(outs, dim=0)[inv_perm.long()]


def _coo_apply(src, tgt, w, x, n_out):
    msgs = w[:, None] * x[src.long()].to(w.dtype)
    out = torch.zeros((n_out, x.shape[1]), dtype=msgs.dtype, device=x.device)
    return out.index_add_(0, tgt.long(), msgs)


def _swap(adj):
    """The same operator in the transpose orientation."""
    if isinstance(adj, EllAdj):
        return EllAdj(idx=adj.idx_t, w=adj.w_t, idx_t=adj.idx, w_t=adj.w)
    if isinstance(adj, BucketedEllAdj):
        return BucketedEllAdj(idx=adj.idx_t, w=adj.w_t, inv_perm=adj.inv_perm_t,
                              idx_t=adj.idx, w_t=adj.w, inv_perm_t=adj.inv_perm)
    return CooAdj(src=adj.src_t, tgt=adj.tgt_t, w=adj.w_t, src_t=adj.src, tgt_t=adj.tgt,
                  w_t=adj.w, n_out=adj.n_in, n_in=adj.n_out)


def _edge_apply(adj, x: torch.Tensor) -> torch.Tensor:
    """The plain product of an edge-list format (spmm.py:397-433, 498-546)."""
    if isinstance(adj, EllAdj):
        return ell_kernels.ell_plain(adj.idx, adj.w, x)
    if isinstance(adj, BucketedEllAdj):
        return _bucketed_apply(adj.idx, adj.w, adj.inv_perm, x)
    return _coo_apply(adj.src, adj.tgt, adj.w, x, adj.n_out)


def _on_card(x: torch.Tensor) -> bool:
    """Whether a product on ``x`` runs on the card (and so through the ELL
    kernels, never their plain version)."""
    return x.device.type == "cuda"


def _propagate_bucketed_kernel(adj: BucketedEllAdj, x: torch.Tensor) -> torch.Tensor:
    """A bucketed ELL product through the ELL kernels: each bucket one launch,
    of the kernel picked by the source count as ``propagate_ell_kernel``
    picks it; the backward runs the same kernel on the transpose buckets."""
    n_in = adj.inv_perm_t.shape[0]
    kernel = (ell_kernels.ell_resident if ell_kernels.resident_supported(n_in)
              else ell_kernels.ell_hbm)
    adj_t = _swap(adj)
    return _LinearOp.apply(
        x, lambda v: _bucketed_apply(adj.idx, adj.w, adj.inv_perm, v, kernel, "fwd"),
        lambda g: _bucketed_apply(adj_t.idx, adj_t.w, adj_t.inv_perm, g, kernel, "bwd"))


# Cap on the [N, chunk, F] gather of the SDDMM, and the K at or below which it
# runs one slot at a time (spmm.py:389-394).
_ELL_CHUNK_BYTES = 256 * 1024 * 1024
_ELL_UNROLL_K = 16


def _sddmm_ell(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """``dw[i, k] = <g[i], x[idx[i, k]]>`` in f32, zero where ``w == 0``, in
    w's type (``_sddmm_ell``, spmm.py:436-468): one slot at a time up to
    ``_ELL_UNROLL_K`` slots, else ``[N, chunk, F]`` gathers of at most
    ``_ELL_CHUNK_BYTES``."""
    n, k = idx.shape
    f = x.shape[-1]
    g32 = g.float()
    x32 = x.float()
    if k <= _ELL_UNROLL_K:
        dw = torch.stack([(g32 * x32[idx[:, j].long()]).sum(-1) for j in range(k)], dim=1)
    else:
        chunk = max(1, min(k, _ELL_CHUNK_BYTES // max(1, 4 * n * f)))
        cols = []
        for start in range(0, k, chunk):
            ic = idx[:, start:start + chunk].long()
            gathered = x32[ic.reshape(-1)].reshape(n, ic.shape[1], f)
            cols.append(torch.einsum("nf,ncf->nc", g32, gathered))
        dw = torch.cat(cols, dim=1)
    return torch.where(w != 0, dw, torch.zeros((), device=dw.device)).to(w.dtype)


def _sddmm(adj, x: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The forward weights' gradients of an edge-list format: one tensor, or
    one a bucket (spmm.py:471-577)."""
    if isinstance(adj, EllAdj):
        return (_sddmm_ell(adj.idx, adj.w, x, g),)
    if isinstance(adj, BucketedEllAdj):
        # out = concat(buckets)[inv_perm]: the concatenation's cotangent is g
        # put back into bucket order.
        g_cat = g[torch.argsort(adj.inv_perm.long())]
        dws, start = [], 0
        for bi, bw in zip(adj.idx, adj.w):
            rows = bi.shape[0]
            dws.append(_sddmm_ell(bi, bw, x, g_cat[start:start + rows]))
            start += rows
        return tuple(dws)
    dw = (g[adj.tgt.long()].float() * x[adj.src.long()].float()).sum(-1)
    return (dw.to(adj.w.dtype),)


def _weights(adj) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """(forward weight leaves, transpose-orientation weight leaves)."""
    if isinstance(adj, BucketedEllAdj):
        return tuple(adj.w), tuple(adj.w_t)
    return (adj.w,), (adj.w_t,)


class _EdgeGradOp(torch.autograd.Function):
    """``y = M x`` whose backward also returns the SDDMM gradients of the
    forward weight leaves, and zeros for the transpose-orientation leaves
    (JAX's strict zeros)."""

    @staticmethod
    def forward(ctx, x, spec, *weights):
        ctx.spec = spec
        ctx.save_for_backward(x)
        return spec[1](x)

    @staticmethod
    def backward(ctx, grad):
        adj, _, apply_t = ctx.spec
        (x,) = ctx.saved_tensors
        return (apply_t(grad), None, *_sddmm(adj, x, grad),
                *(torch.zeros_like(t) for t in _weights(adj)[1]))


def _edge_products(adj, x: torch.Tensor):
    """(forward product, transpose product) of an edge-list format: the ELL
    kernels on the card, the plain version on the CPU."""
    adj_t = _swap(adj)
    if _on_card(x) and not isinstance(adj, CooAdj):
        n_in = adj.idx_t.shape[0] if isinstance(adj, EllAdj) else adj.inv_perm_t.shape[0]
        kernel = (ell_kernels.ell_resident if ell_kernels.resident_supported(n_in)
                  else ell_kernels.ell_hbm)
        if isinstance(adj, EllAdj):
            return (lambda v: kernel(adj.idx, adj.w, v.float().contiguous(), "fwd"),
                    lambda g: kernel(adj_t.idx, adj_t.w, g.float().contiguous(), "bwd"))
        return (lambda v: _bucketed_apply(adj.idx, adj.w, adj.inv_perm, v, kernel, "fwd"),
                lambda g: _bucketed_apply(adj_t.idx, adj_t.w, adj_t.inv_perm, g, kernel, "bwd"))
    return lambda v: _edge_apply(adj, v), lambda g: _edge_apply(adj_t, g)


def _propagate_edge_grads(adj, x: torch.Tensor) -> torch.Tensor:
    apply, apply_t = _edge_products(adj, x)
    fwd_w, t_w = _weights(adj)
    return _EdgeGradOp.apply(x, (adj, apply, apply_t), *fwd_w, *t_w)


def _distributed(adj):
    """The ``parallel/`` module whose operator ``adj`` is, or None."""
    from protgram_directgcn_torch.parallel import gspmd, halo, hyper_shard

    if isinstance(adj, (halo.HaloAdj, halo.TriHaloAdj)):
        return halo
    if isinstance(adj, (hyper_shard.HyperShardAdj, hyper_shard.HyperShardTri)):
        return hyper_shard
    if isinstance(adj, (gspmd.RowShardEllAdj, gspmd.RowShardTri)):
        return gspmd
    return None


def propagate(adj, x: torch.Tensor, edge_grads: Optional[bool] = None) -> torch.Tensor:
    """Sum-aggregate weighted source features at each target node.  ELL
    operators run the ELL kernels on the card, the plain version on the
    CPU.  ``edge_grads=True`` also gives the adjacency's weight leaves the
    SDDMM gradients under autograd (None: the deprecated
    :func:`edge_gradients` default)."""
    eg = _EDGE_GRADS if edge_grads is None else bool(edge_grads)
    if isinstance(adj, DenseAdj):
        return _dense_apply(adj.at, x)
    if eg and isinstance(adj, (EllAdj, BucketedEllAdj, CooAdj)):
        return _propagate_edge_grads(adj, x)
    if isinstance(adj, EllAdj) and _on_card(x):
        return ell_kernels.propagate_ell_kernel(adj, x)
    if isinstance(adj, BucketedEllAdj) and _on_card(x):
        return _propagate_bucketed_kernel(adj, x)
    if isinstance(adj, (EllAdj, BucketedEllAdj, CooAdj)):
        adj_t = _swap(adj)
        return _LinearOp.apply(x, lambda v: _edge_apply(adj, v),
                               lambda g: _edge_apply(adj_t, g))
    if isinstance(adj, BlockNgramAdj):
        return block.propagate_block(adj, x)
    from protgram_directgcn_torch.ops import hypercube

    if isinstance(adj, hypercube.HypercubeAdj):
        return hypercube.propagate_hyper(adj, x, edge_grads=eg)
    mod = _distributed(adj)
    if mod is not None:
        return mod.propagate(adj, x)
    raise TypeError(f"Unknown adjacency type: {type(adj)}")


def propagate_transpose(adj, x: torch.Tensor) -> torch.Tensor:
    """The transpose product ``Mᵀ x`` (out[j] = sum over edges (j -> i) of
    w * x[i]), computed directly from the stored transpose orientation;
    differentiate :func:`propagate` instead."""
    if isinstance(adj, DenseAdj):
        return _dense_apply(adj.at.T, x)
    if isinstance(adj, (EllAdj, BucketedEllAdj, CooAdj)):
        return propagate(_swap(adj), x)
    from protgram_directgcn_torch.ops import hypercube

    if isinstance(adj, hypercube.HypercubeAdj):
        return hypercube.propagate_hyper_transpose(adj, x)
    raise TypeError(f"propagate_transpose: unsupported adjacency {type(adj)}")


def propagate3(graph, x_in: torch.Tensor, x_out: torch.Tensor, x_und: torch.Tensor,
               edge_grads: Optional[bool] = None):
    """The three per-path propagations of a DirectGCN layer; a graph that
    carries a layer-level operator (``graph.tri``: one exchange for the three
    matrices, parallel/) runs it instead (spmm.py:668-704)."""
    tri = getattr(graph, "tri", None)
    if tri is not None:
        return _distributed(tri).propagate_tri(tri, x_in, x_out, x_und)
    return (
        propagate(graph.p_in, x_in, edge_grads),
        propagate(graph.p_out, x_out, edge_grads),
        propagate(graph.p_und, x_und, edge_grads),
    )


def propagate_affine(adj, x: torch.Tensor, scale: float, shift: float) -> torch.Tensor:
    """Fused ``scale * propagate(adj, x) + shift``: inside K2's epilogue on
    the hypercube, an elementwise pass on every other format."""
    from protgram_directgcn_torch.ops import hypercube

    if isinstance(adj, hypercube.HypercubeAdj):
        return hypercube.propagate_hyper_affine(adj, x, scale, shift)
    from protgram_directgcn_torch.parallel import hyper_shard

    if isinstance(adj, hyper_shard.HyperShardAdj):
        return hyper_shard.propagate(adj, x, scale, shift)
    return propagate(adj, x) * scale + shift
