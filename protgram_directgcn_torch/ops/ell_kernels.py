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

``launch_plan`` works out each launch's geometry here, before the launch
(features a thread, threads a row, rows a block, slots staged a pass, the
grid, the streaming hints), from the shapes alone; the entry points check
it and refuse a plan they cannot run.

``propagate_ell_kernel(adj, x)`` dispatches as ``propagate_ell_pallas``
(pallas_spmm.py:111-119) does: by ``adj.idx_t.shape[0]`` (n_in).  Its
backward runs the same kernel on the transpose orientation ``(idx_t, w_t)``
(pallas_spmm.py:100-105): no scatter, and the graph gets no gradient.
Spans (``utils/profiling.py``): each call of an entry point, the CPU's plain
path included, inside ``ops.ell_resident`` or ``ops.ell_hbm`` under a
profiler; the library's build and load inside ``ops.build`` always.
"""

from __future__ import annotations

import ctypes
import functools
import re
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from protgram_directgcn_torch.ops import _nvcc
from protgram_directgcn_torch.utils.profiling import trace

# pallas_spmm.py:32-34: the resident tile is [n_in, 128] f32 within 8 MiB.
_X_RESIDENT_BUDGET = 8 * 1024 * 1024
_F_TILE = 128

# Launches per kernel and direction ("fwd": the forward product, "bwd": the
# transpose-orientation product), and per kernel by the features a thread
# owns (the plan's ``v``: 4, one 16-byte access, or 1).  The wrappers add one
# where they launch a kernel and nowhere else.
LAUNCHES: Dict[str, Dict[str, int]] = {
    "ell_resident": {"fwd": 0, "bwd": 0},
    "ell_hbm": {"fwd": 0, "bwd": 0},
}
LAUNCHES_BY_V: Dict[str, Dict[int, int]] = {"ell_resident": {}, "ell_hbm": {}}

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


def build() -> Dict[str, object]:
    """Compile (``ops/_nvcc.py``) and load the kernel library (idempotent).

    Returns ``{"path", "seconds", "built", "log"}``.
    """
    global _lib
    with _lib_lock:
        if _lib is not None:
            return BUILD_INFO
        with trace("ops.build", always=True):
            info = _nvcc.compile_source("ell")
            lib = ctypes.CDLL(str(info["path"]))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in LAUNCHES:
            fn = getattr(lib, f"{name}_f32")
            # idx, w, x, out, n_out, k, f; the plan: v, ct, rows, kc, grid, hints
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, *[i32] * 7, ptr]
            fn.restype = i32
        lib.ell_occupancy.argtypes = [i32, i32, i32]
        lib.ell_occupancy.restype = i32
        BUILD_INFO.clear()
        BUILD_INFO.update(info)
        _lib = lib
        return BUILD_INFO


def resident_supported(n_in: int) -> bool:
    """``pallas_supported`` (pallas_spmm.py:87): the resident regime holds
    while an [n_in, 128] f32 source tile fits 8 MiB."""
    return n_in * _F_TILE * 4 <= _X_RESIDENT_BUDGET


# -----------------------------------------------------------------------------
# Launch plan
# -----------------------------------------------------------------------------

VEC_BYTES = 16  # one global access a thread at v = 4
# The kernel's bounds, read from the source that compiles it.
_BOUNDS = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                          (_nvcc.CSRC / "ell.cu").read_text()))
MAX_THREADS = int(_BOUNDS["kMaxThreads"])
MAX_SMEM = int(_BOUNDS["kMaxSmemBytes"])
# Two regimes by the size of x (N_in x F f32).  A large table: a row's
# feature tile is one 128-byte line, so the blocks of one tile (the grid's y)
# read a slice of x of N_in lines, which the L2 holds; 128 threads a block;
# idx/w/out streamed past the caches.  A table of at most SMALL_TABLE_BYTES
# stays in L2 whole: 256-byte tiles, 256 threads a block (more rows share
# sources in L1), plain loads.  (PERF.md §6 gives the sweep that chose them.)
SMALL_TABLE_BYTES = 16 << 20
TILE_BYTES = 128
THREADS = 128
SMALL_TABLE_TILE_BYTES = 256
SMALL_TABLE_THREADS = 256
STAGE_BYTES = 16 * 1024  # shared memory for a block's staged idx/w


class LaunchPlan(NamedTuple):
    """Geometry of one ELL launch.  Thread ``t`` of block ``(bx, by)`` serves
    output row ``bx * rows + t // ct`` and features ``[c * v, c * v + v)`` of
    chunk ``c = by * ct + t % ct``; rows past N_out and chunks past F / v
    idle.  The block stages ``kc`` slots of its rows' idx/w a pass."""

    v: int  # features a thread owns: 4 (16 bytes) or 1
    ct: int  # threads of one row, a power of two: the feature tile is ct * v
    rows: int  # consecutive output rows a block
    kc: int  # slots staged in shared memory a pass
    grid: Tuple[int, int]  # (row blocks, feature tiles)
    stream_hints: bool = False  # idx/w read and out written with evict-first hints

    @property
    def threads(self) -> int:
        return self.ct * self.rows

    @property
    def smem(self) -> int:
        return self.rows * self.kc * 8


def _cdiv(n: int, d: int) -> int:
    return -(-n // d)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=1024)
def launch_plan(n_out: int, k: int, f: int, aligned: bool, n_in: int) -> LaunchPlan:
    """The launch on idx/w ``[n_out, k]`` and x ``[n_in, f]`` f32 (cached:
    a wrapper call at the small levels' sizes costs more on the host than
    its kernel).

    ``aligned``: x and out are 16-byte aligned.  16-byte accesses need that
    and ``f % 4 == 0``; otherwise ``v = 1``.  The regime of the table's
    size sets the feature tile a row's threads cover (fewer threads where F
    is narrower), the threads a block (so ``threads // ct`` consecutive
    rows) and the streaming hints; each pass stages up to ``STAGE_BYTES``
    of the block's idx/w (all K slots when they fit).
    """
    small = n_in * f * 4 <= SMALL_TABLE_BYTES
    threads = SMALL_TABLE_THREADS if small else THREADS
    tile_bytes = SMALL_TABLE_TILE_BYTES if small else TILE_BYTES
    v = 4 if aligned and f % 4 == 0 else 1
    nvec = f // v
    ct = min(_pow2_at_least(max(nvec, 1)), max(1, tile_bytes // (4 * v)))
    rows = max(1, threads // ct)
    kc = max(1, min(k, STAGE_BYTES // (rows * 8)))
    return LaunchPlan(v=v, ct=ct, rows=rows, kc=kc,
                      grid=(max(1, _cdiv(n_out, rows)), max(1, _cdiv(nvec, ct))),
                      stream_hints=not small)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % VEC_BYTES == 0 for t in tensors)


def occupancy(plan: LaunchPlan) -> int:
    """Blocks of ``plan`` one SM holds at once (the CUDA occupancy query)."""
    if _lib is None:
        build()
    return int(_lib.ell_occupancy(plan.v, plan.threads, plan.smem))


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
    """Check the inputs and run ``name``: the plain version on the CPU, the
    kernel on the card; inside the span ``ops.<name>`` (under a profiler)."""
    with trace(f"ops.{name}"):
        if idx.dim() != 2 or x.dim() != 2:
            raise ValueError(f"{name}: idx must be [N_out, K] and x [N_in, F], got "
                             f"{tuple(idx.shape)} and {tuple(x.shape)}")
        n_out, k = idx.shape
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
    """Launch ``name`` on checked inputs with ``launch_plan``'s plan; count
    the launch by direction and by ``v``."""
    n_out, k = idx.shape
    n_in, f = x.shape
    out = torch.empty((n_out, f), dtype=torch.float32, device=x.device)
    if n_out == 0 or f == 0:  # nothing to compute: no launch
        return out
    if _lib is None:
        build()
    plan = launch_plan(n_out, k, f, _aligned(x, out), n_in)
    fn = getattr(_lib, f"{name}_f32")
    rc = fn(idx.data_ptr(), w.data_ptr(), x.data_ptr(), out.data_ptr(), n_out, k, f, plan.v,
            plan.ct, plan.rows, plan.kc, *plan.grid, int(plan.stream_hints), _nvcc.stream_ptr(x))
    _nvcc.raise_on(rc, name)
    LAUNCHES[name][direction] += 1
    LAUNCHES_BY_V[name][plan.v] = LAUNCHES_BY_V[name].get(plan.v, 0) + 1
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
