"""The ELL SpMM kernels (CUDA C++, ``csrc/ell.cu``) and their autograd.

Replaces the two Pallas kernels of protgram_directgcn_tpu/ops/pallas_spmm.py:

- ``ell_resident`` <- ``_ell_pallas_raw`` (:72), the source table resident
  on chip, taken while ``resident_supported(n_in)``: n_in * 128 * 4 bytes
  <= 8 MiB, i.e. n_in <= 16,384 (all n <= 3 n-gram levels);
- ``ell_hbm`` <- ``_ell_hbm_raw`` (:204), the table in device memory, for
  larger n_in (the n = 4 level).

Both compute ``out[i, :] = sum_k w[i, k] * x[idx[i, k], :]`` with idx int32
``[N_out, K]``, w f32 ``[N_out, K]``, x ``[N_in, F]`` and out f32
``[N_out, F]``, f32 accumulation over the slots in slot order.  The TPU
kernels' row and 128-lane padding and their k-major weights are TPU layout
work with no counterpart here.  The source is built like ``csrc/hyper.cu``
(``ops/_nvcc.py``).  CPU tensors take the plain PyTorch versions below;
CUDA tensors launch the kernels or raise.

``propagate_ell_kernel(adj, x)`` dispatches as ``propagate_ell_pallas``
(pallas_spmm.py:111-119) does: by ``adj.idx_t.shape[0]`` (n_in).  Its
backward runs the same kernel on the transpose orientation ``(idx_t, w_t)``
(pallas_spmm.py:100-105): no scatter, and the graph gets no gradient.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from protgram_directgcn_torch.ops import _nvcc

# pallas_spmm.py:32-34: the resident tile is [n_in, 128] f32 within 8 MiB.
_X_RESIDENT_BUDGET = 8 * 1024 * 1024
_F_TILE = 128

# Launches per kernel and direction ("fwd": the forward product, "bwd": the
# transpose-orientation product).  The wrappers add one where they launch a
# kernel and nowhere else.
LAUNCHES: Dict[str, Dict[str, int]] = {
    "ell_resident": {"fwd": 0, "bwd": 0},
    "ell_hbm": {"fwd": 0, "bwd": 0},
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
    """Compile (``ops/_nvcc.py``) and load the kernel library (idempotent).

    Returns ``{"path", "seconds", "built", "log"}``.
    """
    global _lib
    with _lib_lock:
        if _lib is not None:
            return BUILD_INFO
        info = _nvcc.compile_source("ell")
        lib = ctypes.CDLL(str(info["path"]))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in LAUNCHES:
            fn = getattr(lib, f"{name}_f32")
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
            fn.restype = i32
        BUILD_INFO.clear()
        BUILD_INFO.update(info)
        _lib = lib
        return BUILD_INFO


def resident_supported(n_in: int) -> bool:
    """``pallas_supported`` (pallas_spmm.py:87): the resident regime holds
    while an [n_in, 128] f32 source tile fits 8 MiB."""
    return n_in * _F_TILE * 4 <= _X_RESIDENT_BUDGET


# -----------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# -----------------------------------------------------------------------------


def ell_plain(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_k w[i, k] * x[idx[i, k]]`` in f32, one slot at a time in
    slot order; also the ELL format's own product (ops/spmm.py)."""
    x32 = x.float()
    acc = torch.zeros((idx.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    for k in range(idx.shape[1]):
        acc = acc + w[:, k : k + 1] * x32[idx[:, k].long()]
    return acc


def ell_resident_plain(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The resident kernel's plain version (:func:`ell_plain`)."""
    return ell_plain(idx, w, x)


def ell_hbm_plain(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The HBM kernel's plain version (:func:`ell_plain`)."""
    return ell_plain(idx, w, x)


# -----------------------------------------------------------------------------
# Wrappers
# -----------------------------------------------------------------------------


def _launch(name: str, idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
            direction: str) -> torch.Tensor:
    if idx.dim() != 2 or x.dim() != 2:
        raise ValueError(f"{name}: idx must be [N_out, K] and x [N_in, F], got "
                         f"{tuple(idx.shape)} and {tuple(x.shape)}")
    n_out, k = idx.shape
    f = x.shape[1]
    _nvcc.check_tensor("idx", idx, (n_out, k), torch.int32, x.device)
    _nvcc.check_tensor("w", w, (n_out, k), torch.float32, x.device)
    _nvcc.check_tensor("x", x, tuple(x.shape), torch.float32, x.device)
    if x.device.type == "cpu":
        return ell_plain(idx, w, x)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return _launch_cuda(name, idx, w, x, direction)


def _launch_cuda(name: str, idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                 direction: str) -> torch.Tensor:
    """Launch ``name`` on checked inputs; count the launch."""
    n_out, k = idx.shape
    f = x.shape[1]
    out = torch.empty((n_out, f), dtype=torch.float32, device=x.device)
    if n_out == 0 or f == 0:  # nothing to compute: no launch
        return out
    if _lib is None:
        build()
    fn = getattr(_lib, f"{name}_f32")
    rc = fn(idx.data_ptr(), w.data_ptr(), x.data_ptr(), out.data_ptr(), n_out, k, f,
            _nvcc.stream_ptr(x))
    _nvcc.raise_on(rc, name)
    LAUNCHES[name][direction] += 1
    return out


def ell_resident(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                 direction: str = "fwd") -> torch.Tensor:
    """The resident-regime kernel on idx int32 ``[N_out, K]``, w f32
    ``[N_out, K]`` and x f32 ``[N_in, F]``, all contiguous on one device;
    returns f32 ``[N_out, F]``."""
    return _launch("ell_resident", idx, w, x, direction)


def ell_hbm(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
            direction: str = "fwd") -> torch.Tensor:
    """The HBM-regime kernel; the same contract as :func:`ell_resident`."""
    return _launch("ell_hbm", idx, w, x, direction)


class _PropagateEll(torch.autograd.Function):
    """ELL product through one kernel, whose backward is the same kernel on
    the transpose orientation (pallas_spmm.py:91-108, 224-241)."""

    @staticmethod
    def forward(ctx, x, idx, w, idx_t, w_t, kernel):
        ctx.save_for_backward(idx_t, w_t)
        ctx.kernel = kernel
        return kernel(idx, w, x.float().contiguous(), "fwd")

    @staticmethod
    def backward(ctx, grad):
        idx_t, w_t = ctx.saved_tensors
        dx = ctx.kernel(idx_t, w_t, grad.float().contiguous(), "bwd")
        return dx, None, None, None, None, None


def propagate_ell_kernel(adj, x: torch.Tensor) -> torch.Tensor:
    """ELL propagation through the kernel of its regime: resident while
    ``resident_supported(n_in)``, with n_in read from ``adj.idx_t``, else
    HBM (``propagate_ell_pallas``, pallas_spmm.py:111-119)."""
    kernel = ell_resident if resident_supported(adj.idx_t.shape[0]) else ell_hbm
    return _PropagateEll.apply(x, adj.idx, adj.w, adj.idx_t, adj.w_t, kernel)
