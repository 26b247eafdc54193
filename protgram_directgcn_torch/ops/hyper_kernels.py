"""K1/K2: the hypercube propagation kernels (CUDA C++, ``csrc/hyper.cu``).

Replaces the two Pallas kernels of ``apply_hyper_pallas``
(protgram_directgcn_tpu/ops/pallas_hyper.py:217 and :245).  What each one
computes, for an rg-layout carry ``x [A, G, F]`` and r-major banks
``w [A, G, A]`` (f32 accumulation, stored in the carry dtype):

- K1: ``z[g, c, f] = sum_r w1[r, g, c] * x[r, g, f]``, written ``[G, A, F]``
  and viewed, with no copy, as rg ``[A, G, F]``;
- K2: ``out[r, g, f] = scale * (z[r, g, f] + d[r, g] * x[r, g, f]
  + sum_c w2[r, g, c] * x_gc[g, c, f]) + shift``, with ``x_gc`` the memory
  of ``x`` indexed ``[G, A, F]`` and ``d [A, G]`` f32.

The source is compiled with ``nvcc`` for ``sm_90a`` into a plain-C shared
library under ``protgram_directgcn_torch/_build/`` at first use, again only
when the source's hash changes (``ops/_nvcc.py``), and loaded with
``ctypes``.  CPU tensors take the plain PyTorch versions below; CUDA tensors
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from protgram_directgcn_torch.ops import _nvcc

BUILD_DIR = _nvcc.BUILD_DIR

# Launches per kernel and direction ("fwd": forward product, "bwd": the
# bank-swapped transpose product of the backward pass).  The wrappers add one
# where they launch a kernel and nowhere else.
LAUNCHES: Dict[str, Dict[str, int]] = {
    "k1": {"fwd": 0, "bwd": 0},
    "k2": {"fwd": 0, "bwd": 0},
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

    Returns ``{"path", "seconds", "built", "log", "max_alphabet"}``.
    """
    global _lib
    with _lib_lock:
        if _lib is not None:
            return BUILD_INFO
        info = _nvcc.compile_source("hyper")
        lib = ctypes.CDLL(str(info["path"]))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for dt in ("f32", "bf16"):
            k1 = getattr(lib, f"hyper_k1_{dt}")
            k1.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
            k1.restype = i32
            k2 = getattr(lib, f"hyper_k2_{dt}")
            k2.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, f32, f32, ptr]
            k2.restype = i32
        lib.hyper_max_alphabet.argtypes = []
        lib.hyper_max_alphabet.restype = i32
        info["max_alphabet"] = int(lib.hyper_max_alphabet())
        BUILD_INFO.clear()
        BUILD_INFO.update(info)
        _lib = lib
        return BUILD_INFO


# -----------------------------------------------------------------------------
# Checks
# -----------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_inputs(x: torch.Tensor, banks, d: Optional[torch.Tensor] = None):
    if x.dim() != 3:
        raise ValueError(f"x must be rg [A, G, F], got shape {tuple(x.shape)}")
    a, g, f = x.shape
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x dtype {x.dtype} unsupported (float32 or bfloat16)")
    _nvcc.check_tensor("x", x, (a, g, f), x.dtype, x.device)
    for name, w in banks:
        _nvcc.check_tensor(name, w, (a, g, a), x.dtype, x.device)
    if d is not None:
        _nvcc.check_tensor("d", d, (a, g), torch.float32, x.device)
    return a, g, f


def _library(a: int) -> ctypes.CDLL:
    if _lib is None:
        build()
    if a > BUILD_INFO["max_alphabet"]:
        raise ValueError(
            f"alphabet {a} > {BUILD_INFO['max_alphabet']}, the kernels' per-thread column"
        )
    return _lib


# -----------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# -----------------------------------------------------------------------------


def k1_plain(w1: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``z [G, A, F]`` in the carry dtype (f32 accumulation)."""
    return torch.einsum("rgc,rgf->gcf", w1.float(), x.float()).to(x.dtype)


def k2_plain(d: torch.Tensor, w2: torch.Tensor, z_rg: torch.Tensor, x: torch.Tensor,
             scale: float = 1.0, shift: float = 0.0) -> torch.Tensor:
    a, g, f = x.shape
    x32 = x.float()
    y2 = torch.einsum("rgc,gcf->rgf", w2.float(), x32.reshape(g, a, f))
    acc = z_rg.float() + d.float()[:, :, None] * x32 + y2
    return (acc * scale + shift).to(x.dtype)


# -----------------------------------------------------------------------------
# Wrappers
# -----------------------------------------------------------------------------


def k1(w1: torch.Tensor, x: torch.Tensor, direction: str = "fwd") -> torch.Tensor:
    """K1 on ``x [A, G, F]`` and bank ``w1 [A, G, A]``; returns ``z [G, A, F]``."""
    a, g, f = _check_inputs(x, [("w1", w1)])
    if x.device.type == "cpu":
        return k1_plain(w1, x)
    if x.device.type != "cuda":
        raise ValueError(f"k1: unsupported device {x.device}")
    lib = _library(a)
    z = torch.empty((g, a, f), dtype=x.dtype, device=x.device)
    fn = getattr(lib, f"hyper_k1_{_SUFFIX[x.dtype]}")
    rc = fn(w1.data_ptr(), x.data_ptr(), z.data_ptr(), a, g, f, _nvcc.stream_ptr(x))
    _nvcc.raise_on(rc, "K1")
    LAUNCHES["k1"][direction] += 1
    return z


def k2(d: torch.Tensor, w2: torch.Tensor, z_rg: torch.Tensor, x: torch.Tensor,
       scale: float = 1.0, shift: float = 0.0, direction: str = "fwd") -> torch.Tensor:
    """K2 on ``x [A, G, F]``, bank ``w2 [A, G, A]``, ``z_rg [A, G, F]`` and
    diagonal ``d [A, G]`` f32; returns ``out [A, G, F]``."""
    a, g, f = _check_inputs(x, [("w2", w2)], d)
    _nvcc.check_tensor("z", z_rg, (a, g, f), x.dtype, x.device)
    if x.device.type == "cpu":
        return k2_plain(d, w2, z_rg, x, scale, shift)
    if x.device.type != "cuda":
        raise ValueError(f"k2: unsupported device {x.device}")
    lib = _library(a)
    out = torch.empty_like(x)
    fn = getattr(lib, f"hyper_k2_{_SUFFIX[x.dtype]}")
    rc = fn(d.data_ptr(), w2.data_ptr(), z_rg.data_ptr(), x.data_ptr(), out.data_ptr(),
            a, g, f, float(scale), float(shift), _nvcc.stream_ptr(x))
    _nvcc.raise_on(rc, "K2")
    LAUNCHES["k2"][direction] += 1
    return out

