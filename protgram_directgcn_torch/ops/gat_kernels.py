"""GAT's multi-head edge softmax and aggregation on an ELL table (CUDA C++,
``csrc/gat.cu``), its autograd, and its plain PyTorch versions.

No TPU kernel of the JAX package computes this: its zoo GAT (and the port's,
``models/zoo.py``) forms per-edge messages ``z[src] * alpha`` of shape
[E, H, F] and sums them with a scatter.  At the published PPI widths on the
n = 4 level one such tensor is 13.4 GB, so ``models/gat.py`` trains through
these kernels, which keep no per-edge tensor wider than the head count.

The table (``GatTable``, ``build_table``): the in-edges j -> i of every
target row i, with the graph's self loops removed and one added a node (PyG
``remove_self_loops`` then ``add_self_loops``), unweighted, as an ELL table
(``ops/spmm.py`` ``build_ell`` with unit weights: ``w`` is 1 on a real slot
and 0 on padding) and its transpose; ``perm`` names each edge's slot in the
transpose.

One layer: ``gat_attention(z, a_src, a_dst, table)`` with z [N, H*F],
a_src, a_dst [N, H] returns [N, H*F], ``out[i, h] = sum_j alpha_ijh z[j, h]``
over i's in-edges with ``alpha`` the softmax over them of
``LeakyReLU_0.2(a_src[j, h] + a_dst[i, h])``.

- Forward: ``softmax`` (alpha [N, K, H] and the statistics lse [N, H]),
  then ``aggregate`` (the alpha-weighted ELL product); alpha is freed, lse
  and the output are kept.
- Backward: ``edge_grad`` (per slot and head the SDDMM <dout_i, z_j>, alpha
  recomputed from lse, the softmax's and the LeakyReLU's derivatives: dpre
  and alpha written in the transpose table's layout [N, Kt, H], and
  d_a_dst), ``aggregate`` on the transpose table (dz), and d_a_src, the sum
  of dpre over each source's transpose slots.

CPU tensors take the plain versions (also the kernels' oracle: they loop
over the K slots, so they too hold no [E, H, F] tensor); CUDA tensors launch
the kernels or raise.  ``LAUNCHES`` counts the launches by kernel and
direction.  Spans (``utils/profiling.py``, under a profiler): the forward
inside ``ops.gat_attn``, the backward inside ``ops.gat_attn_bwd``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from protgram_directgcn_torch.ops import _nvcc, ell_kernels
from protgram_directgcn_torch.ops.spmm import build_ell
from protgram_directgcn_torch.utils.profiling import trace

NEG_SLOPE = 0.2
MAX_HEADS = 32  # csrc/gat.cu kMaxHeads
SOFTMAX_THREADS = 256  # eight (row, head) pairs a block
EDGE_GRAD_THREADS = 256  # eight warps over a row's slots

LAUNCHES: Dict[str, Dict[str, int]] = {
    "gat_softmax": {"fwd": 0},
    "gat_aggregate": {"fwd": 0, "bwd": 0},
    "gat_edge_grad": {"bwd": 0},
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    for per_dir in LAUNCHES.values():
        for k in per_dir:
            per_dir[k] = 0


def launch_counts() -> Dict[str, Dict[str, int]]:
    return {name: dict(per_dir) for name, per_dir in LAUNCHES.items()}


def build() -> Dict[str, object]:
    """Compile (``ops/_nvcc.py``) and load the kernel library (idempotent);
    returns ``{"path", "seconds", "built", "log"}``."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return BUILD_INFO
        with trace("ops.build", always=True):
            info = _nvcc.compile_source("gat")
            lib = ctypes.CDLL(str(info["path"]))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gat_softmax_f32.argtypes = [*[ptr] * 6, *[i32] * 4, ptr]
        lib.gat_aggregate_f32.argtypes = [*[ptr] * 4, *[i32] * 11, ptr]
        lib.gat_edge_grad_f32.argtypes = [*[ptr] * 12, *[i32] * 6, ptr]
        for fn in (lib.gat_softmax_f32, lib.gat_aggregate_f32, lib.gat_edge_grad_f32):
            fn.restype = i32
        BUILD_INFO.clear()
        BUILD_INFO.update(info)
        _lib = lib
        return BUILD_INFO


# -----------------------------------------------------------------------------
# The table
# -----------------------------------------------------------------------------


@dataclasses.dataclass
class GatTable:
    """A level's attention table: ``idx``/``mask`` [N, K] (the in-edges of
    each target, ``mask`` 1 on a real slot), ``idx_t`` [N, Kt] (the targets
    of each source; its padding takes weight 0 in the backward) and ``perm``
    [N, K] int32 (the flat transpose slot ``j * Kt + t`` of each in-table
    slot, -1 on padding)."""

    idx: torch.Tensor
    mask: torch.Tensor
    idx_t: torch.Tensor
    perm: torch.Tensor
    num_edges: int  # in-edges with the self loops
    # What train_level reads of a level's operators (``DeviceGraph``'s names).
    route = "gat_ell"
    node_map = None

    @property
    def num_nodes(self) -> int:
        return int(self.idx.shape[0])

    @property
    def k(self) -> int:
        return int(self.idx.shape[1])

    @property
    def k_t(self) -> int:
        return int(self.idx_t.shape[1])


def self_looped_edges(src: np.ndarray, tgt: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The edges without their self loops, then one self loop a node
    (PyG ``remove_self_loops`` + ``add_self_loops``); duplicates are kept."""
    src = np.asarray(src, dtype=np.int64)
    tgt = np.asarray(tgt, dtype=np.int64)
    keep = src != tgt
    loops = np.arange(n, dtype=np.int64)
    return np.concatenate([src[keep], loops]), np.concatenate([tgt[keep], loops])


def _slot_of_each_edge(rows: np.ndarray, n: int) -> np.ndarray:
    """The ELL slot each edge takes in its row: the rank of the edge among
    its row's edges in a stable sort by row (``_ell_one_sided``'s order)."""
    order = np.argsort(rows, kind="stable")
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=starts[1:])
    slot = np.empty(len(rows), dtype=np.int64)
    slot[order] = np.arange(len(rows), dtype=np.int64) - starts[rows[order]]
    return slot


def build_table(src: np.ndarray, tgt: np.ndarray, n: int, device="cuda") -> GatTable:
    """The attention table of the directed edges ``src -> tgt`` over ``n``
    nodes (self loops replaced by one a node)."""
    s, t = self_looped_edges(src, tgt, n)
    ell = build_ell(s, t, np.ones(len(s), np.float32), n, device=device)
    k, kt = ell.idx.shape[1], ell.idx_t.shape[1]
    perm = np.full((n, k), -1, dtype=np.int32)
    perm[t, _slot_of_each_edge(t, n)] = s * kt + _slot_of_each_edge(s, n)
    return GatTable(idx=ell.idx, mask=ell.w, idx_t=ell.idx_t,
                    perm=torch.from_numpy(perm).to(device), num_edges=int(len(s)))


# -----------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# -----------------------------------------------------------------------------


def softmax_plain(idx: torch.Tensor, mask: torch.Tensor, a_src: torch.Tensor,
                  a_dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha [N, K, H], lse [N, H]): the softmax over each row's real slots
    of ``LeakyReLU(a_src[idx] + a_dst)``; alpha 0 on padding."""
    valid = (mask != 0)[..., None]
    e = F.leaky_relu(a_src[idx.long()] + a_dst[:, None, :], NEG_SLOPE)
    e = torch.where(valid, e, e.new_full((), -torch.inf))
    m = e.amax(1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    lse = m + torch.log(torch.exp(e - m[:, None]).sum(1))
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    alpha = torch.where(valid, torch.exp(e - lse[:, None]), e.new_zeros(()))
    return alpha, lse


def aggregate_plain(idx: torch.Tensor, alpha: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[i, h*F + f] = sum_k alpha[i, k, h] * x[idx[i, k], h*F + f]``,
    one slot at a time in slot order."""
    n, k = idx.shape
    h = alpha.shape[-1]
    xs = x.reshape(x.shape[0], h, -1)
    acc = torch.zeros((n, h, xs.shape[-1]), dtype=x.dtype, device=x.device)
    for j in range(k):
        acc = acc + alpha[:, j, :, None] * xs[idx[:, j].long()]
    return acc.reshape(n, -1)


def edge_grad_plain(idx, mask, perm, k_t, z, dout, out, a_src, a_dst, lse):
    """(dpre_t [N_t, Kt, H], alpha_t [N_t, Kt, H], d_a_dst [N, H]): per real
    slot and head, ``d_alpha = <dout_i, z_j>``, alpha from ``lse``, ``de =
    alpha * (d_alpha - <dout_i, out_i>)`` and dpre its LeakyReLU
    derivative's product, d_a_dst the sum of dpre over a row's slots; dpre
    and alpha placed at each edge's transpose slot ``perm`` (0 on the
    transpose's padding)."""
    n, k = idx.shape
    h = a_src.shape[1]
    do = dout.reshape(n, h, -1)
    zs = z.reshape(z.shape[0], h, -1)
    d = (do * out.reshape(n, h, -1)).sum(-1)
    dpre, alpha = [], []
    for j in range(k):
        src = idx[:, j].long()
        valid = (mask[:, j] != 0)[:, None]
        pre = a_src[src] + a_dst
        a = torch.exp(F.leaky_relu(pre, NEG_SLOPE) - lse)
        de = a * ((do * zs[src]).sum(-1) - d)
        g = torch.where(pre > 0, de, NEG_SLOPE * de)
        zero = z.new_zeros(())
        dpre.append(torch.where(valid, g, zero))
        alpha.append(torch.where(valid, a, zero))
    dpre, alpha = torch.stack(dpre, 1), torch.stack(alpha, 1)
    real = perm.reshape(-1) >= 0
    to = perm.reshape(-1)[real].long()
    out_t = []
    for t in (dpre, alpha):
        placed = t.new_zeros((z.shape[0] * k_t, h))
        placed[to] = t.reshape(-1, h)[real]
        out_t.append(placed.reshape(z.shape[0], k_t, h))
    return out_t[0], out_t[1], dpre.sum(1)


# -----------------------------------------------------------------------------
# Wrappers
# -----------------------------------------------------------------------------


def _cuda(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if _lib is None:
        build()
    return True


def _ftype(t: torch.Tensor) -> torch.dtype:
    """The floating type the wrappers take: float32 on the card; on the CPU
    the tensor's own (the plain versions also run in float64, for
    ``gradcheck``)."""
    return t.dtype if t.device.type == "cpu" and t.dtype == torch.float64 else torch.float32


def _check_table(idx, mask, device) -> Tuple[int, int]:
    if idx.dim() != 2:
        raise ValueError(f"idx must be [N, K], got {tuple(idx.shape)}")
    n, k = idx.shape
    _nvcc.check_tensor("idx", idx, (n, k), torch.int32, device)
    _nvcc.check_tensor("mask", mask, (n, k), torch.float32, device)
    return n, k


def softmax(idx: torch.Tensor, mask: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alpha [N, K, H], lse [N, H]); see :func:`softmax_plain`."""
    n, k = _check_table(idx, mask, a_dst.device)
    h = a_dst.shape[1]
    ft = _ftype(a_dst)
    _nvcc.check_tensor("a_src", a_src, (a_src.shape[0], h), ft, a_dst.device)
    _nvcc.check_tensor("a_dst", a_dst, (n, h), ft, a_dst.device)
    if not _cuda("gat_softmax", a_dst):
        return softmax_plain(idx, mask, a_src, a_dst)
    alpha = torch.empty((n, k, h), dtype=torch.float32, device=a_dst.device)
    lse = torch.empty((n, h), dtype=torch.float32, device=a_dst.device)
    rc = _lib.gat_softmax_f32(idx.data_ptr(), mask.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(),
                              alpha.data_ptr(), lse.data_ptr(), n, k, h, SOFTMAX_THREADS,
                              _nvcc.stream_ptr(a_dst))
    _nvcc.raise_on(rc, "gat_softmax")
    LAUNCHES["gat_softmax"]["fwd"] += 1
    return alpha, lse


def launch_plan(n_out: int, k: int, heads: int, f: int, aligned: bool, n_in: int
                ) -> ell_kernels.LaunchPlan:
    """The aggregation's launch on idx [n_out, k] and x [n_in, heads * f]:
    ``ell_kernels.launch_plan``'s geometry (16 bytes a thread only where a
    vector stays inside one head, ``f % 4 == 0``), with each pass staging
    up to ``ell_kernels.STAGE_BYTES`` of the block's slots at ``4 + 4 *
    heads`` bytes a slot (its index and its heads' weights)."""
    plan = ell_kernels.launch_plan(n_out, k, heads * f, aligned and f % 4 == 0, n_in)
    kc = max(1, min(k, ell_kernels.STAGE_BYTES // (plan.rows * 4 * (1 + heads))))
    return plan._replace(kc=kc)


def aggregate(idx: torch.Tensor, alpha: torch.Tensor, x: torch.Tensor,
              direction: str = "fwd") -> torch.Tensor:
    """[N_out, H*F] from idx [N_out, K], alpha [N_out, K, H] and x
    [N_in, H*F]; see :func:`aggregate_plain`."""
    n, k = idx.shape
    h = alpha.shape[-1]
    dev = x.device
    _nvcc.check_tensor("idx", idx, (n, k), torch.int32, dev)
    _nvcc.check_tensor("x", x, tuple(x.shape), _ftype(x), dev)
    _nvcc.check_tensor("alpha", alpha, tuple(alpha.shape), _ftype(x), dev)
    if x.dim() != 2 or x.shape[1] % h:
        raise ValueError(f"x must be [N_in, H*F] with H = {h}, got {tuple(x.shape)}")
    if tuple(alpha.shape) != (n, k, h):
        raise ValueError(f"alpha must be [{n}, {k}, {h}], got {tuple(alpha.shape)}")
    if not _cuda("gat_aggregate", x):
        return aggregate_plain(idx, alpha, x)
    f = x.shape[1] // h
    out = torch.empty((n, h * f), dtype=torch.float32, device=dev)
    if n == 0 or f == 0:
        return out
    plan = launch_plan(n, k, h, f, x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0,
                       x.shape[0])
    rc = _lib.gat_aggregate_f32(idx.data_ptr(), alpha.data_ptr(), x.data_ptr(),
                                out.data_ptr(), n, k, h, f, plan.v, plan.ct, plan.rows, plan.kc,
                                *plan.grid, int(plan.stream_hints), _nvcc.stream_ptr(x))
    _nvcc.raise_on(rc, "gat_aggregate")
    LAUNCHES["gat_aggregate"][direction] += 1
    return out


def edge_grad(idx, mask, perm, k_t, z, dout, out, a_src, a_dst, lse):
    """(dpre_t [N_t, Kt, H], alpha_t [N_t, Kt, H], d_a_dst [N, H]) with
    N_t = z's rows; see :func:`edge_grad_plain`."""
    n, k = _check_table(idx, mask, z.device)
    _nvcc.check_tensor("perm", perm, (n, k), torch.int32, z.device)
    h = a_dst.shape[1]
    dev = z.device
    for name, t, shape in (("z", z, (z.shape[0], z.shape[1])), ("dout", dout, (n, z.shape[1])),
                           ("out", out, (n, z.shape[1])), ("a_src", a_src, (z.shape[0], h)),
                           ("a_dst", a_dst, (n, h)), ("lse", lse, (n, h))):
        _nvcc.check_tensor(name, t, shape, _ftype(z), dev)
    if h > MAX_HEADS or z.shape[1] % h:
        raise ValueError(f"edge_grad: {h} heads (at most {MAX_HEADS}) over width {z.shape[1]}")
    if not _cuda("gat_edge_grad", z):
        return edge_grad_plain(idx, mask, perm, k_t, z, dout, out, a_src, a_dst, lse)
    f = z.shape[1] // h
    dpre = torch.zeros((z.shape[0], k_t, h), dtype=torch.float32, device=dev)
    alpha = torch.zeros((z.shape[0], k_t, h), dtype=torch.float32, device=dev)
    d_a_dst = torch.empty((n, h), dtype=torch.float32, device=dev)
    v = 4 if f % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (z, dout, out)) else 1
    rc = _lib.gat_edge_grad_f32(idx.data_ptr(), mask.data_ptr(), perm.data_ptr(), z.data_ptr(),
                                dout.data_ptr(),
                                out.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(),
                                lse.data_ptr(), dpre.data_ptr(), alpha.data_ptr(),
                                d_a_dst.data_ptr(), n, k, h, f, v, EDGE_GRAD_THREADS,
                                _nvcc.stream_ptr(z))
    _nvcc.raise_on(rc, "gat_edge_grad")
    LAUNCHES["gat_edge_grad"]["bwd"] += 1
    return dpre, alpha, d_a_dst


class _GatAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, a_src, a_dst, table):
        with trace("ops.gat_attn"):
            z = z.contiguous()
            a_src, a_dst = a_src.contiguous(), a_dst.contiguous()
            alpha, lse = softmax(table.idx, table.mask, a_src, a_dst)
            out = aggregate(table.idx, alpha, z)
            del alpha
        ctx.table = table
        ctx.save_for_backward(z, a_src, a_dst, lse, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        table = ctx.table
        z, a_src, a_dst, lse, out = ctx.saved_tensors
        with trace("ops.gat_attn_bwd"):
            dout = dout.contiguous()
            dpre_t, alpha_t, d_a_dst = edge_grad(table.idx, table.mask, table.perm, table.k_t,
                                                 z, dout, out, a_src, a_dst, lse)
            dz = aggregate(table.idx_t, alpha_t, dout, "bwd")
            del alpha_t
            d_a_src = dpre_t.sum(1)
        return dz, d_a_src, d_a_dst, None


def gat_attention(z: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                  table: GatTable) -> torch.Tensor:
    """One layer's attention over ``table``: z [N, H*F] and a_src, a_dst
    [N, H] f32 to [N, H*F] (see the module's docstring)."""
    return _GatAttention.apply(z, a_src, a_dst, table)
