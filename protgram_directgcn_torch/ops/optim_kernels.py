"""The optimizer's pass over the parameters (CUDA C++, ``csrc/optim.cu``).

Two multi-tensor kernels, each one launch over up to ``TABLE_LEAVES``
leaves:

- ``adam``: one Adam step (optax ``scale_by_adam`` with its float32 bias
  corrections) over leaves at one step count, with ``c * p`` added to the
  gradient first (weight decay, or the L2 term's 2 * lambda) and rounded to
  the leaf's type; p and g float32 or bfloat16, the moments float32.  Each
  element's p, g, mu and nu are read once and p, mu and nu written once;
- ``sum_squares``: the sum of squares of leaves in float32 (the loss's L2
  term), deterministic.

They replace no TPU kernel: optax and the L2 term ran under XLA.  The
source is built like ``csrc/hyper.cu`` (``ops/_nvcc.py``).  CPU tensors
take the plain PyTorch versions below (``torch._foreach_*`` over the
float32 leaves, slice by slice over the others); CUDA tensors launch the
kernels or raise.  Spans (``utils/profiling.py``): each launch inside
``ops.adam`` or ``ops.l2`` under a profiler, the library's build and load
inside ``ops.build`` always.
"""

from __future__ import annotations

import ctypes
import re
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from protgram_directgcn_torch.ops import _nvcc
from protgram_directgcn_torch.utils.profiling import trace

# Launches per kernel.  The wrappers add one where they launch a kernel and
# nowhere else.
LAUNCHES: Dict[str, int] = {"adam": 0, "l2": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
BUILD_INFO: Dict[str, object] = {}

# The kernels' bounds, read from the source that compiles them.
_BOUNDS = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                          (_nvcc.CSRC / "optim.cu").read_text()))
TABLE_LEAVES = int(_BOUNDS["kTableLeaves"])
SUM_BLOCKS = int(_BOUNDS["kSumBlocks"])
_BF16, _ALIGNED = 1, 2  # a leaf's flags
_DTYPES = (torch.float32, torch.bfloat16)

# Per device: the sum's f64 partials and its counter (0 between launches).
_SCRATCH: Dict[torch.device, tuple] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def build() -> Dict[str, object]:
    """Compile (``ops/_nvcc.py``) and load the kernel library (idempotent).

    Returns ``{"path", "seconds", "built", "log"}``.
    """
    global _lib
    with _lib_lock:
        if _lib is not None:
            return BUILD_INFO
        with trace("ops.build", always=True):
            info = _nvcc.compile_source("optim")
            lib = ctypes.CDLL(str(info["path"]))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.optim_adam.argtypes = [i32, ptr, ptr, ptr] + [f32] * 9 + [ptr]
        lib.optim_adam.restype = i32
        lib.optim_sum_squares.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.optim_sum_squares.restype = i32
        BUILD_INFO.clear()
        BUILD_INFO.update(info)
        _lib = lib
        return BUILD_INFO


def _library() -> ctypes.CDLL:
    if _lib is None:
        build()
    return _lib


# -----------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# -----------------------------------------------------------------------------


def row_slices(t: torch.Tensor, chunk: int) -> List[slice]:
    """Slices of ``t``'s first dim of at most ``chunk`` elements (one row
    at least), so that an update's f32 temporaries stay bounded."""
    rows = max(1, chunk // max(1, t[0].numel()))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def grad_f32(p: torch.Tensor, sl: slice, c: float) -> torch.Tensor:
    """The gradient of rows ``sl`` in f32, with ``c * p`` added in f32 and
    rounded to the parameter's type (optax ``add_decayed_weights``)."""
    g = p.grad[sl].float()
    if c:
        g = (g + c * p[sl].float()).to(p.dtype).float()
    return g


def apply_direction(p: torch.Tensor, sl: slice, lr: float, direction: torch.Tensor) -> None:
    """``p -= lr * direction`` in f32, stored in the parameter's type."""
    p[sl] = (p[sl].float() - lr * direction).to(p.dtype)


def adam_plain(ps: Sequence[torch.Tensor], mus, nus, lr: float, b1: float, b2: float,
               eps: float, bc1: float, bc2: float, c: float, chunk: int) -> None:
    """One Adam step of ``ps`` (their ``.grad``) at one step count: the
    float32 leaves of at most ``chunk`` elements together, one
    ``torch._foreach_*`` launch per operation (torch.optim.Adam's
    multi-tensor path); every other leaf on its own, ``chunk`` elements a
    slice."""
    small = [i for i, p in enumerate(ps) if p.dtype == torch.float32 and p.numel() <= chunk]
    if small:
        p_s = [ps[i] for i in small]
        m_s, v_s = [mus[i] for i in small], [nus[i] for i in small]
        grads = [p.grad for p in p_s]
        if c:
            grads = torch._foreach_add(grads, p_s, alpha=c)
        torch._foreach_mul_(m_s, b1)
        torch._foreach_add_(m_s, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v_s, b2)
        torch._foreach_addcmul_(v_s, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(v_s, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        direction = torch._foreach_div(m_s, bc1)
        torch._foreach_div_(direction, denom)
        torch._foreach_add_(p_s, direction, alpha=-lr)
    rest = set(small)
    for i, p in enumerate(ps):
        if i in rest:
            continue
        for sl in row_slices(p, chunk):
            g = grad_f32(p, sl, c)
            mu = mus[i][sl].mul_(b1).add_(g, alpha=1.0 - b1)
            nu = nus[i][sl].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            apply_direction(p, sl, lr, (mu / bc1) / (torch.sqrt(nu / bc2) + eps))


def sum_squares_plain(ts: Sequence[torch.Tensor], chunk: int) -> torch.Tensor:
    """Sum of squares of ``ts`` in f32, slice by slice."""
    total = torch.zeros((), dtype=torch.float32, device=ts[0].device)
    with torch.no_grad():
        for t in ts:
            for sl in row_slices(t.reshape(-1), chunk):
                total += torch.sum(torch.square(t.reshape(-1)[sl].float()))
    return total


# -----------------------------------------------------------------------------
# Wrappers
# -----------------------------------------------------------------------------


def _device_of(ts: Sequence[torch.Tensor], what: str) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{what}: the leaves lie on more than one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def _check_leaf(what: str, p: torch.Tensor, others: Sequence[torch.Tensor]) -> None:
    if p.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {p.dtype} unsupported (float32 or bfloat16)")
    for name, t, dtype in zip(("grad", "mu", "nu"), others,
                              (p.dtype, torch.float32, torch.float32)):
        _nvcc.check_tensor(f"{what} {name}", t, tuple(p.shape), dtype, p.device)
    if not p.is_contiguous():
        raise ValueError(f"{what}: parameters must be contiguous")


def _tables(ps: Sequence[torch.Tensor], ptrs: np.ndarray):
    """The leaves' sizes and flags, then each launch's columns."""
    numel = np.array([p.numel() for p in ps], dtype=np.int64)
    bf16 = np.array([p.dtype == torch.bfloat16 for p in ps])
    # 16 bytes for the f32 arrays, 8 for a bf16 leaf's p and g (4 elements).
    align = np.where(bf16, 8, 16)[None, :].repeat(ptrs.shape[0], 0)
    align[2:] = 16
    aligned = (ptrs % align == 0).all(0)
    flags = (bf16 * _BF16 + aligned * _ALIGNED).astype(np.uint8)
    for lo in range(0, len(ps), TABLE_LEAVES):
        cols = slice(lo, lo + TABLE_LEAVES)
        yield (np.ascontiguousarray(ptrs[:, cols]), np.ascontiguousarray(numel[cols]),
               np.ascontiguousarray(flags[cols]))


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def adam(ps: Sequence[torch.Tensor], mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
         lr: float, b1: float, b2: float, eps: float, bc1: float, bc2: float, c: float,
         chunk: int) -> None:
    """One Adam step of leaves ``ps`` (their ``.grad``) at one step count,
    in place: moments ``mus``, ``nus`` (f32), bias corrections ``bc1``,
    ``bc2``, ``c * p`` added to the gradient.  ``chunk``: the plain
    version's slice (CPU tensors)."""
    if not ps:
        return
    dev = _device_of(ps, "adam")
    if dev.type == "cpu":
        adam_plain(ps, mus, nus, lr, b1, b2, eps, bc1, bc2, c, chunk)
        return
    for p, mu, nu in zip(ps, mus, nus):
        _check_leaf("adam", p, (p.grad, mu, nu))
    with trace("ops.adam"):
        ptrs = np.array([[t.data_ptr() for t in ts]
                         for ts in (ps, [p.grad for p in ps], mus, nus)], dtype=np.int64)
        stream = _nvcc.stream_ptr(ps[0])
        fn = _library().optim_adam
        for cols, numel, flags in _tables(ps, ptrs):
            rc = fn(len(numel), _ptr(cols), _ptr(numel), _ptr(flags), lr, b1, b2, 1.0 - b1,
                    1.0 - b2, bc1, bc2, eps, c, stream)
            _nvcc.raise_on(rc, "adam")
            LAUNCHES["adam"] += 1


def _scratch(dev: torch.device):
    if dev not in _SCRATCH:
        _SCRATCH[dev] = (torch.empty(SUM_BLOCKS, dtype=torch.float64, device=dev),
                         torch.zeros(1, dtype=torch.int32, device=dev))
    return _SCRATCH[dev]


def sum_squares(ts: Sequence[torch.Tensor], chunk: int) -> torch.Tensor:
    """Sum of squares of ``ts`` as a 0-dim f32 tensor on their device (one
    launch a table of leaves).  ``chunk``: the plain version's slice."""
    dev = _device_of(ts, "sum_squares")
    if dev.type == "cpu":
        return sum_squares_plain(ts, chunk)
    for t in ts:
        if t.dtype not in _DTYPES:
            raise TypeError(f"sum_squares: dtype {t.dtype} unsupported (float32 or bfloat16)")
        if not t.is_contiguous():
            raise ValueError("sum_squares: leaves must be contiguous")
    with trace("ops.l2"):
        ptrs = np.array([[t.data_ptr() for t in ts]], dtype=np.int64)
        tables = list(_tables(ts, ptrs))
        out = torch.empty(len(tables), dtype=torch.float32, device=dev)
        partials, counter = _scratch(dev)
        stream = _nvcc.stream_ptr(ts[0])
        fn = _library().optim_sum_squares
        for k, (cols, numel, flags) in enumerate(tables):
            rc = fn(len(numel), _ptr(cols), _ptr(numel), _ptr(flags), partials.data_ptr(),
                    counter.data_ptr(), out.data_ptr() + 4 * k, stream)
            _nvcc.raise_on(rc, "sum_squares")
            LAUNCHES["l2"] += 1
    return out[0] if len(tables) == 1 else out.sum()
