"""K1/K2: the hypercube propagation kernels (CUDA C++, ``csrc/hyper.cu``).

Replaces the two Pallas kernels of ``apply_hyper_pallas``
(protgram_directgcn_tpu/ops/pallas_hyper.py:217 and :245).  What each one
computes, for an rg-layout carry ``x [A, G, F]`` and r-major banks
``w [A, G, A]`` (f32 accumulation, stored in the carry dtype):

- K1: ``z[g, c, f] = sum_r w1[r, g, c] * x[r, g, f]``, written ``[G, A, F]``
  and viewed, with no copy, as rg ``[A, G, F]``;
- K2: ``out[r, g, f] = scale * (z[r, g, f] + d[r, g] * x[r, g, f]
  + sum_c w2[r, g, c] * x_gc[g, c, f]) + shift``, with ``d [A, G]`` f32 and
  ``x_gc`` ``[G, A, F]``: by default the memory of ``x`` itself; on a key
  shard of ``parallel/hyper_shard.py`` the gc block the exchange delivered,
  passed as its own pointer.

The source is compiled with ``nvcc`` for ``sm_90a`` into a plain-C shared
library under ``protgram_directgcn_torch/_build/`` at first use, again only
when the source's hash changes (``ops/_nvcc.py``), and loaded with
``ctypes``.  CPU tensors take the plain PyTorch versions below; CUDA tensors
launch the kernels or raise.  ``launch_plan`` works out each launch's
geometry here, before the launch; the entry points check it and refuse a
plan they cannot run.
"""

from __future__ import annotations

import ctypes
import functools
import re
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from protgram_directgcn_torch.ops import _nvcc

BUILD_DIR = _nvcc.BUILD_DIR

# Launches per kernel and direction ("fwd": forward product, "bwd": the
# bank-swapped transpose product of the backward pass), and per kernel by the
# features a thread owns (the plan's ``v``: 1, or 16 bytes' worth).  The
# wrappers add one where they launch a kernel and nowhere else.
LAUNCHES: Dict[str, Dict[str, int]] = {
    "k1": {"fwd": 0, "bwd": 0},
    "k2": {"fwd": 0, "bwd": 0},
}
LAUNCHES_BY_V: Dict[str, Dict[int, int]] = {"k1": {}, "k2": {}}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    for per_dir in LAUNCHES.values():
        for k in per_dir:
            per_dir[k] = 0
    for per_v in LAUNCHES_BY_V.values():
        per_v.clear()


def launch_counts() -> Dict[str, Dict[str, int]]:
    return {name: dict(per_dir) for name, per_dir in LAUNCHES.items()}


def launch_counts_by_v() -> Dict[str, Dict[int, int]]:
    return {name: dict(per_v) for name, per_v in LAUNCHES_BY_V.items()}


def _count(kernel: str, direction: str, v: int) -> None:
    LAUNCHES[kernel][direction] += 1
    LAUNCHES_BY_V[kernel][v] = LAUNCHES_BY_V[kernel].get(v, 0) + 1


def build() -> Dict[str, object]:
    """Compile (``ops/_nvcc.py``) and load the kernel library (idempotent).

    Returns ``{"path", "seconds", "built", "log"}``.
    """
    global _lib
    with _lib_lock:
        if _lib is not None:
            return BUILD_INFO
        info = _nvcc.compile_source("hyper")
        lib = ctypes.CDLL(str(info["path"]))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        plan = [i32] * 7  # v, amax, keys, ct, threads, grid_x, grid_y
        for dt in ("f32", "bf16"):
            k1 = getattr(lib, f"hyper_k1_{dt}")
            k1.argtypes = [ptr, ptr, ptr, i32, i32, i32, *plan, ptr]
            k1.restype = i32
            k2 = getattr(lib, f"hyper_k2_{dt}")
            # d, w2, z, x_gc, x, out
            k2.argtypes = [ptr] * 6 + [i32, i32, i32, f32, f32, *plan, ptr]
            k2.restype = i32
        BUILD_INFO.clear()
        BUILD_INFO.update(info)
        _lib = lib
        return BUILD_INFO


# -----------------------------------------------------------------------------
# Launch plan
# -----------------------------------------------------------------------------

VEC_BYTES = 16  # one global access a thread
# The kernels' bounds, read from the source that compiles them: the largest
# compile-time bound of the loops over A, keys a block, threads a block.
_BOUNDS = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                          (_nvcc.CSRC / "hyper.cu").read_text()))
MAX_ALPHABET = int(_BOUNDS["kMaxAlphabet"])
MAX_KEYS = int(_BOUNDS["kMaxKeys"])
MAX_THREADS = int(_BOUNDS["kMaxThreads"])


class LaunchPlan(NamedTuple):
    """Geometry of one K1 or K2 launch.  Thread ``t`` of block ``(bx, by)``
    takes key ``bx * keys + t // ct`` and the ``v`` features from column
    ``(by * ct + t % ct) * v``; threads past ``keys * ct``, keys past G and
    chunks past F / v idle."""

    v: int  # features a thread owns in each row: 16 bytes' worth, or 1
    amax: int  # the instantiation: compile-time bound of the loops over A
    keys: int  # consecutive keys a block
    ct: int  # chunks of one key a block
    threads: int
    grid: Tuple[int, int]


def _cdiv(n: int, d: int) -> int:
    return -(-n // d)


def launch_plan(a: int, g: int, f: int, dtype: torch.dtype, aligned: bool,
                sms: int) -> LaunchPlan:
    """The launch of K1 or K2 on a carry ``[A, G, F]`` of ``dtype`` on a card
    of ``sms`` streaming multiprocessors.

    ``aligned``: every carry pointer of the launch is 16-byte aligned.  16-byte
    accesses need that and ``F * itemsize % 16 == 0``; otherwise ``v = 1``.
    The loops over A are bounded by 21 (the paths' alphabet) or
    ``MAX_ALPHABET``.  Keys a block grow with G while the grid keeps at least
    one block per SM (G = 441 takes 3 on an H100 SXM, G = 21 one), up to
    ``MAX_KEYS`` and ``MAX_THREADS``.
    """
    if not 1 <= a <= MAX_ALPHABET:
        raise ValueError(f"alphabet {a} outside 1..{MAX_ALPHABET}, the kernels' unrolled bound")
    v = VEC_BYTES // dtype.itemsize if aligned and (f * dtype.itemsize) % VEC_BYTES == 0 else 1
    chunks = f // v
    grid_y = _cdiv(chunks, MAX_THREADS)
    ct = _cdiv(chunks, grid_y)
    keys = max(1, min(MAX_KEYS, g // sms, MAX_THREADS // ct))
    threads = _cdiv(keys * ct, 32) * 32
    return LaunchPlan(v=v, amax=21 if a == 21 else MAX_ALPHABET, keys=keys, ct=ct,
                      threads=threads, grid=(_cdiv(g, keys), grid_y))


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % VEC_BYTES == 0 for t in tensors)


@functools.lru_cache(maxsize=256)
def _plan_args(a: int, g: int, f: int, dtype: torch.dtype, aligned: bool,
               device: int) -> Tuple[int, ...]:
    """``launch_plan`` on CUDA device ``device`` as the entry points take it,
    cached: a wrapper call at the main path's sizes costs more on the host
    than its kernel on the card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = launch_plan(a, g, f, dtype, aligned, sms)
    return (plan.v, plan.amax, plan.keys, plan.ct, plan.threads, *plan.grid)


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


def _library() -> ctypes.CDLL:
    if _lib is None:
        build()
    return _lib


# -----------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# -----------------------------------------------------------------------------


def k1_plain(w1: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``z [G, A, F]`` in the carry dtype (f32 accumulation)."""
    return torch.einsum("rgc,rgf->gcf", w1.float(), x.float()).to(x.dtype)


def k2_plain(d: torch.Tensor, w2: torch.Tensor, z_rg: torch.Tensor, x: torch.Tensor,
             scale: float = 1.0, shift: float = 0.0,
             x_gc: Optional[torch.Tensor] = None) -> torch.Tensor:
    a, g, f = x.shape
    x32 = x.float()
    gc = x32.reshape(g, a, f) if x_gc is None else x_gc.float()
    y2 = torch.einsum("rgc,gcf->rgf", w2.float(), gc)
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
    z = torch.empty((g, a, f), dtype=x.dtype, device=x.device)
    plan = _plan_args(a, g, f, x.dtype, _aligned(x, z), x.device.index)
    fn = getattr(_library(), f"hyper_k1_{_SUFFIX[x.dtype]}")
    rc = fn(w1.data_ptr(), x.data_ptr(), z.data_ptr(), a, g, f, *plan, _nvcc.stream_ptr(x))
    _nvcc.raise_on(rc, "K1")
    _count("k1", direction, plan[0])
    return z


def k2(d: torch.Tensor, w2: torch.Tensor, z_rg: torch.Tensor, x: torch.Tensor,
       scale: float = 1.0, shift: float = 0.0, direction: str = "fwd",
       x_gc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 on ``x [A, G, F]``, bank ``w2 [A, G, A]``, ``z_rg [A, G, F]`` and
    diagonal ``d [A, G]`` f32; returns ``out [A, G, F]``.  ``x_gc [G, A, F]``
    is the product's operand where it is not the memory of ``x``."""
    a, g, f = _check_inputs(x, [("w2", w2)], d)
    _nvcc.check_tensor("z", z_rg, (a, g, f), x.dtype, x.device)
    if x_gc is not None:
        _nvcc.check_tensor("x_gc", x_gc, (g, a, f), x.dtype, x.device)
    if x.device.type == "cpu":
        return k2_plain(d, w2, z_rg, x, scale, shift, x_gc)
    if x.device.type != "cuda":
        raise ValueError(f"k2: unsupported device {x.device}")
    gc = x if x_gc is None else x_gc
    out = torch.empty_like(x)
    plan = _plan_args(a, g, f, x.dtype, _aligned(x, gc, z_rg, out), x.device.index)
    fn = getattr(_library(), f"hyper_k2_{_SUFFIX[x.dtype]}")
    rc = fn(d.data_ptr(), w2.data_ptr(), z_rg.data_ptr(), gc.data_ptr(), x.data_ptr(),
            out.data_ptr(), a, g, f, float(scale), float(shift), *plan, _nvcc.stream_ptr(x))
    _nvcc.raise_on(rc, "K2")
    _count("k2", direction, plan[0])
    return out

