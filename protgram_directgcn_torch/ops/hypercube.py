"""Hypercube-factorised propagation for n-gram matrices (gather-free).

Port of protgram_directgcn_tpu/ops/hypercube.py:60-316, 339-535.
With the node id of n-gram (c_1 .. c_n) := sum_i code(c_i) * A^(n-i) over the
sorted alphabet of size A, every propagation matrix of an n-gram level
(pattern inside union(A, Aᵀ, I), reference: graph_utils.py:198-287) is

    out = d * x                              (diagonal)
        + sum_r wf[r,g,c] * x[r*G+g]          (A  pattern, out at g*A+c)
        + sum_c wb[r,g,c] * x[g*A+c]          (Aᵀ pattern, out at r*G+g)

per-key [A x A] contractions over G = A^(n-1) keys, with no gathers.  The
features ride in the rg layout ``[A, G, F]`` (flat order == node order) and
both banks are kept r-major ``[A, G, A]``.  One propagation is the K1/K2
kernel pair of ops/hyper_kernels.py; the transpose product (the backward
pass) is the same pair with the banks swapped.

The JAX package's g-major and packed bank layouts, the 128-lane feature
padding and the Pallas block sizing exist to dodge TPU tile padding
(pallas_hyper.py:1-24) and have no counterpart here; ``convert.hyper_from_jax``
reads any of those layouts into this one.  ``edge_grads=True`` gives the
diagonal and the two banks the SDDMM gradients (``_sddmm_hyper``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from protgram_directgcn_torch.ops import hyper_kernels
from protgram_directgcn_torch.ops.block import BankBudgetError, BlockStructureError


@dataclasses.dataclass
class HypercubeAdj:
    """Positional-id factorisation of an n-gram propagation matrix over the
    hypercube node space [A^n]; real nodes live at ``node_map``."""

    d: torch.Tensor  # [A, G] f32 diagonal (rg layout)
    wf_rs: torch.Tensor  # [A, G, A]: wf_rs[r, g, c] = w(r·G+g -> g·A+c)
    wb_rs: torch.Tensor  # [A, G, A]: wb_rs[r, g, c] = w(g·A+c -> r·G+g)
    node_map: torch.Tensor  # [N_real] int64 hypercube id per real node

    bank_layout = "rs"

    @property
    def n_out(self) -> int:
        return self.d.shape[0] * self.d.shape[1]

    @property
    def alphabet(self) -> int:
        return self.d.shape[0]

    @property
    def feature_shape(self) -> Tuple[int, int]:
        """Leading dims of the rg feature layout [A, G]."""
        return (self.d.shape[0], self.d.shape[1])


def vocab_char_codes(vocab: np.ndarray) -> Tuple[np.ndarray, int]:
    """Per-node character codes [N, n] over the sorted alphabet of ``vocab``."""
    vocab = np.asarray(vocab)
    n_nodes = len(vocab)
    if n_nodes == 0:
        return np.zeros((0, 1), np.int64), 0
    n = len(str(vocab[0]))
    chars = vocab.astype(f"U{n}").view("U1").reshape(n_nodes, n)
    alphabet, flat = np.unique(chars, return_inverse=True)
    return flat.reshape(n_nodes, n).astype(np.int64), int(len(alphabet))


def hypercube_bank_bytes(g: int, a: int, itemsize: int) -> int:
    """Device bytes of the two r-major banks."""
    return 2 * a * g * a * itemsize


def build_hypercube(
    src: np.ndarray,
    tgt: np.ndarray,
    val: np.ndarray,
    codes: np.ndarray,
    alphabet_size: int,
    max_block_bytes: int = 6 << 30,
    weights_dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
) -> HypercubeAdj:
    """Factor a coalesced COO matrix over positional hypercube ids, with the
    (r, g, c) bank coordinates of the JAX package (hypercube.py:198-228).

    Raises BlockStructureError when n < 2 or an off-diagonal edge fits
    neither key pattern, BankBudgetError when the banks exceed
    ``max_block_bytes``.  The diagonal stays f32.
    """
    codes = np.asarray(codes, np.int64)
    _, n = codes.shape
    a = int(alphabet_size)
    if n < 2:
        raise BlockStructureError("hypercube format needs n >= 2")
    g = a ** (n - 1)
    n_hyper = a**n
    itemsize = torch.empty(0, dtype=weights_dtype).element_size()
    if hypercube_bank_bytes(g, a, itemsize) > max_block_bytes:
        raise BankBudgetError(
            f"hypercube banks would occupy {hypercube_bank_bytes(g, a, itemsize)} bytes "
            f"(budget {max_block_bytes})"
        )

    pows = a ** np.arange(n - 1, -1, -1, dtype=np.int64)
    hyper = codes @ pows  # [N_real] positional id
    src = np.asarray(src, np.int64)
    tgt = np.asarray(tgt, np.int64)
    val = np.asarray(val, np.float32)

    pk = hyper // a  # prefix key
    sk = hyper % g  # suffix key
    first = codes[:, 0]
    last = codes[:, -1]

    diag = src == tgt
    d = np.zeros(n_hyper, np.float32)
    np.add.at(d, hyper[src[diag]], val[diag])

    off = ~diag
    s, t, v = src[off], tgt[off], val[off]
    fwd = sk[s] == pk[t]
    bwd = ~fwd & (pk[s] == sk[t])
    leftover = int((~fwd & ~bwd).sum())
    if leftover:
        raise BlockStructureError(f"{leftover} edges fit neither the A nor the Aᵀ n-gram pattern")

    sf, tf, vf = s[fwd], t[fwd], v[fwd]
    sb, tb, vb = s[bwd], t[bwd], v[bwd]

    # A-pattern edge coords:  r = first[src], g = suffix key of src, c = last[tgt].
    # Aᵀ-pattern edge coords: r = first[tgt], g = prefix key of src, c = last[src].
    def bank(flat, vals):
        w = np.zeros(a * g * a, np.float32)
        np.add.at(w, flat, vals)
        return torch.from_numpy(w.reshape(a, g, a)).to(device=device, dtype=weights_dtype)

    return HypercubeAdj(
        d=torch.from_numpy(d.reshape(a, g)).to(device),
        wf_rs=bank((first[sf] * g + sk[sf]) * a + last[tf], vf),
        wb_rs=bank((first[tb] * g + pk[sb]) * a + last[sb], vb),
        node_map=torch.from_numpy(hyper).to(device),
    )


def embed_features(adj: HypercubeAdj, x_real: torch.Tensor) -> torch.Tensor:
    """Scatter real-node features into the hypercube layout (absent ids = 0)."""
    out = x_real.new_zeros((adj.n_out,) + tuple(x_real.shape[1:]))
    out[adj.node_map] = x_real
    return out


def extract_features(adj: HypercubeAdj, x_hyper: torch.Tensor) -> torch.Tensor:
    """Gather real-node rows back out of the hypercube layout."""
    if x_hyper.dim() == 3:  # rg layout
        x_hyper = x_hyper.reshape((x_hyper.shape[0] * x_hyper.shape[1],) + tuple(x_hyper.shape[2:]))
    return x_hyper[adj.node_map]


# -----------------------------------------------------------------------------
# Propagation
# -----------------------------------------------------------------------------


def _hyper_apply(d, w1, w2, x_rg, scale=1.0, shift=0.0, direction="fwd"):
    """``scale * (M x) + shift`` in rg layout: K1 with the A-pattern bank
    ``w1``, then K2 with the Aᵀ-pattern bank ``w2``, the diagonal and the
    epilogue.  The transpose product is the same call with the banks
    swapped.  Every dtype and every G goes through the kernels on the card
    (their plain versions on the CPU)."""
    x_rg = x_rg.contiguous()
    a, g, f = x_rg.shape
    z = hyper_kernels.k1(w1, x_rg, direction)
    return hyper_kernels.k2(d, w2, z.view(a, g, f), x_rg, scale, shift, direction)


def _sddmm_hyper(grad: torch.Tensor, x_rg: torch.Tensor, scale: float):
    """Gradients of ``scale * (M x) + shift`` w.r.t. the diagonal and the two
    banks, the hypercube SDDMM (``_sddmm_hyper``, hypercube.py:412-444), in
    f32 and the "rs" layout:

        dd[r, g]     = scale * <grad[r, g, :], x[r, g, :]>
        dwf[r, g, c] = scale * <grad_gc[g, c, :], x[r, g, :]>
        dwb[r, g, c] = scale * <grad[r, g, :], x_gc[g, c, :]>

    Dense over the banks: structural zeros (absent node pairs) get gradient
    too, as in the JAX package (the bank is the parameter; mask it with its
    pattern to forbid new edges)."""
    a, g, f = x_rg.shape
    g32 = grad.float()
    x32 = x_rg.float()
    dd = (g32 * x32).sum(-1) * scale
    dwf = torch.einsum("gcf,rgf->rgc", g32.reshape(g, a, f), x32) * scale
    dwb = torch.einsum("rgf,gcf->rgc", g32, x32.reshape(g, a, f)) * scale
    return dd, dwf, dwb


class _PropagateHyperAffine(torch.autograd.Function):
    """``scale * (M x) + shift`` whose backward is the same K1/K2 pair with
    the banks swapped, ``scale`` in the epilogue and ``shift = 0``
    (hypercube.py:461-479).  The graph gets no gradient unless
    ``edge_grads``: then the diagonal and both banks get the SDDMM's."""

    @staticmethod
    def forward(ctx, x, d, wf, wb, scale, shift, edge_grads=False):
        ctx.save_for_backward(d, wf, wb, x if edge_grads else None)
        ctx.scale = scale
        ctx.edge_grads = edge_grads
        return _hyper_apply(d, wf, wb, x, scale, shift, "fwd")

    @staticmethod
    def backward(ctx, grad):
        d, wf, wb, x = ctx.saved_tensors
        dx = _hyper_apply(d, wb, wf, grad, ctx.scale, 0.0, "bwd")
        if not ctx.edge_grads:
            return dx, None, None, None, None, None, None
        dd, dwf, dwb = _sddmm_hyper(grad, x, ctx.scale)
        return dx, dd.to(d.dtype), dwf.to(wf.dtype), dwb.to(wb.dtype), None, None, None


def propagate_hyper_affine(adj: HypercubeAdj, x: torch.Tensor, scale: float,
                           shift: float, edge_grads: bool = False) -> torch.Tensor:
    """Fused ``scale * (M x) + shift``.  ``x`` is flat ``[A^n, F]`` or rg
    ``[A, G, F]``; the output has the input's layout."""
    a, g = adj.feature_shape
    flat_in = x.dim() == 2
    x_rg = x.reshape(a, g, x.shape[-1]) if flat_in else x
    out = _PropagateHyperAffine.apply(x_rg, adj.d, adj.wf_rs, adj.wb_rs, float(scale),
                                      float(shift), bool(edge_grads))
    return out.reshape(a * g, -1) if flat_in else out


def propagate_hyper(adj: HypercubeAdj, x: torch.Tensor, edge_grads: bool = False) -> torch.Tensor:
    """out[i] = sum over edges (j -> i) of w * x[j], in hypercube ids."""
    return propagate_hyper_affine(adj, x, 1.0, 0.0, edge_grads)


def propagate_hyper_transpose(adj: HypercubeAdj, x: torch.Tensor) -> torch.Tensor:
    """The transpose product Mᵀx, computed directly (the same kernels with the
    banks' roles swapped); for backward passes that hold the cotangent."""
    a, g = adj.feature_shape
    flat_in = x.dim() == 2
    x_rg = x.reshape(a, g, x.shape[-1]) if flat_in else x
    out = _hyper_apply(adj.d, adj.wb_rs, adj.wf_rs, x_rg, 1.0, 0.0, "bwd")
    return out.reshape(a * g, -1) if flat_in else out
