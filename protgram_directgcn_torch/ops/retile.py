"""Pack/unpack of the sub-128-wide rg carry (CUDA C++, ``csrc/retile.cu``).

Replaces the two Pallas kernels of protgram_directgcn_tpu/ops/pallas_retile.py:

- ``unpack`` <- ``_unpack_pad_impl`` (:78): packed ``[A, GP, 128]`` to
  ``[A, GP*k, 128]`` with k = 128 / f: node j of packed row i lands on row
  k*i + j, lanes ``[0:f]``, and lanes ``[f:128]`` are zero;
- ``pack`` <- ``_pack_impl`` (:109): ``[A, G8, f]``, or the f-padded
  ``[A, G8, 128]`` read at lanes ``[0:f]`` only, to ``[A, G8/k, 128]``;
  G8 must be a multiple of k.

f is 8, 16, 32 or 64; the type float32 or bfloat16.  Pure data movement:
the kernels are bound by bytes.  The memory tier that rematerialises per
path (tier 3 of the trainer's plan) packs the carry of such widths
(``models/directgcn.pack_rg_carry``).  On the TPU a sub-128-lane buffer
pads to 128 lanes in device memory, which packing avoids; on the card a
buffer takes its logical size either way, so the port packs for parity of
layout with the JAX package, and on an exact-width contiguous carry the
packed form is the same memory as a ``reshape`` view.

The source is built like ``csrc/hyper.cu`` (``ops/_nvcc.py``).  CPU tensors
take the plain PyTorch versions below; CUDA tensors launch the kernels or
raise.  ``pack_rg`` and ``unpack_pad_rg`` are the differentiable entry
points: each one's backward is the other kernel (pallas_retile.py:123-144).
Spans (``utils/profiling.py``): each launch inside ``ops.pack`` or
``ops.unpack`` under a profiler, the library's build and load inside
``ops.build`` always.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from protgram_directgcn_torch.ops import _nvcc
from protgram_directgcn_torch.utils.profiling import trace

WIDTHS = (8, 16, 32, 64)
LANES = 128

# Launches per kernel and direction ("fwd": called in a forward pass, "bwd":
# called as the other kernel's backward).  The wrappers add one where they
# launch a kernel and nowhere else.
LAUNCHES: Dict[str, Dict[str, int]] = {
    "pack": {"fwd": 0, "bwd": 0},
    "unpack": {"fwd": 0, "bwd": 0},
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
BUILD_INFO: Dict[str, object] = {}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


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
        with trace("ops.build", always=True):
            info = _nvcc.compile_source("retile")
            lib = ctypes.CDLL(str(info["path"]))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for dt in _SUFFIX.values():
            unpack_fn = getattr(lib, f"retile_unpack_{dt}")
            unpack_fn.argtypes = [ptr, ptr, i64, i32, ptr]
            unpack_fn.restype = i32
            pack_fn = getattr(lib, f"retile_pack_{dt}")
            pack_fn.argtypes = [ptr, ptr, i64, i32, i32, ptr]
            pack_fn.restype = i32
        BUILD_INFO.clear()
        BUILD_INFO.update(info)
        _lib = lib
        return BUILD_INFO


# -----------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# -----------------------------------------------------------------------------


def unpack_plain(t: torch.Tensor, f: int) -> torch.Tensor:
    """The unpack as ``_unpack_body`` writes it: lane segment j of every
    packed row, zero-padded to 128 lanes, becomes row k*i + j."""
    a, gp, _ = t.shape
    k = LANES // f
    rows = [F.pad(t[..., j * f:(j + 1) * f], (0, LANES - f)) for j in range(k)]
    return torch.stack(rows, dim=2).reshape(a, gp * k, LANES)


def pack_plain(t: torch.Tensor, f: int) -> torch.Tensor:
    """The pack as ``_pack_body`` writes it: rows k*i + j (lanes ``[0:f]``)
    side by side as the lane segments j of packed row i."""
    k = LANES // f
    return torch.cat([t[:, j::k, :f] for j in range(k)], dim=-1).contiguous()


# -----------------------------------------------------------------------------
# Wrappers
# -----------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, f: int) -> None:
    if f not in WIDTHS:
        raise ValueError(f"{name}: width f={f} unsupported (one of {WIDTHS})")
    if t.dim() != 3:
        raise ValueError(f"{name}: expected [A, G, lanes], got shape {tuple(t.shape)}")
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {t.dtype} unsupported (float32 or bfloat16)")
    _nvcc.check_tensor(name, t, tuple(t.shape), t.dtype, t.device)
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _library() -> ctypes.CDLL:
    if _lib is None:
        build()
    return _lib


def unpack(t: torch.Tensor, f: int, direction: str = "fwd") -> torch.Tensor:
    """Packed ``[A, GP, 128]`` -> ``[A, GP*k, 128]``, lanes ``[f:128]`` zero."""
    _check("unpack", t, f)
    a, gp, lanes = t.shape
    if lanes != LANES:
        raise ValueError(f"unpack: packed rows must be {LANES} wide, got {lanes}")
    if t.device.type == "cpu":
        return unpack_plain(t, f)
    if t.device.type != "cuda":
        raise ValueError(f"unpack: unsupported device {t.device}")
    with trace("ops.unpack"):
        out = torch.empty((a, gp * (LANES // f), LANES), dtype=t.dtype, device=t.device)
        if out.numel() == 0:  # nothing to move: no launch
            return out
        fn = getattr(_library(), f"retile_unpack_{_SUFFIX[t.dtype]}")
        _nvcc.raise_on(fn(t.data_ptr(), out.data_ptr(), a * gp, f, _nvcc.stream_ptr(t)),
                       "unpack")
        LAUNCHES["unpack"][direction] += 1
    return out


def pack(t: torch.Tensor, f: int, direction: str = "fwd") -> torch.Tensor:
    """``[A, G8, f]`` or ``[A, G8, 128]`` (lanes ``[0:f]`` read) ->
    ``[A, G8/k, 128]``; G8 must be a multiple of k = 128 / f."""
    _check("pack", t, f)
    a, g8, lanes = t.shape
    k = LANES // f
    if lanes not in (f, LANES):
        raise ValueError(f"pack: input rows must be {f} or {LANES} wide, got {lanes}")
    if g8 % k:
        raise ValueError(f"pack: G={g8} is not a multiple of k={k} (pad it first)")
    if t.device.type == "cpu":
        return pack_plain(t, f)
    if t.device.type != "cuda":
        raise ValueError(f"pack: unsupported device {t.device}")
    with trace("ops.pack"):
        out = torch.empty((a, g8 // k, LANES), dtype=t.dtype, device=t.device)
        if out.numel() == 0:
            return out
        fn = getattr(_library(), f"retile_pack_{_SUFFIX[t.dtype]}")
        rc = fn(t.data_ptr(), out.data_ptr(), a * (g8 // k), f, lanes, _nvcc.stream_ptr(t))
        _nvcc.raise_on(rc, "pack")
        LAUNCHES["pack"][direction] += 1
    return out


class _Unpack(torch.autograd.Function):
    """Unpack whose backward is the pack kernel: the cotangent's pad lanes
    are not read, as the forward wrote zeros there (pallas_retile.py:126)."""

    @staticmethod
    def forward(ctx, t, f):
        ctx.f = f
        return unpack(t.contiguous(), f, "fwd")

    @staticmethod
    def backward(ctx, grad):
        return pack(grad.contiguous(), ctx.f, "bwd"), None


class _Pack(torch.autograd.Function):
    """Pack whose backward is the unpack kernel, cut back to the input's
    width when that was f (pallas_retile.py:137-141)."""

    @staticmethod
    def forward(ctx, t, f):
        ctx.f = f
        ctx.lanes = t.shape[-1]
        return pack(t.contiguous(), f, "fwd")

    @staticmethod
    def backward(ctx, grad):
        dt = unpack(grad.contiguous(), ctx.f, "bwd")
        return (dt if ctx.lanes == LANES else dt[..., :ctx.lanes]), None


def unpack_pad_rg(t: torch.Tensor, f: int) -> torch.Tensor:
    """Differentiable unpack (``unpack_pad_rg_pallas``)."""
    return _Unpack.apply(t, f)


def pack_rg(t: torch.Tensor, f: int) -> torch.Tensor:
    """Differentiable pack (``pack_rg_pallas``)."""
    return _Pack.apply(t, f)
