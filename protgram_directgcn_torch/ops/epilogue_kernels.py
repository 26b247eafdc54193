"""The DirectGCN layer's elementwise tail (CUDA C++, ``csrc/epilogue.cu``),
its autograd, and its plain PyTorch versions.

One layer's tail runs from its three propagated paths to its activation:

    s   = c_all * (c_und * (pu + b_und) + c_dir * (c_in * (pi + b_in)
                                                + c_out * (po + b_out))) + const + res
    out = where(u < keep, leaky_relu(s) / keep, 0)          (out = leaky_relu(s) without u)

with the biases the sums ``b_main + b_shared``, the gates ``[N, 1]`` (a
node's) or ``(1,)``, ``const`` the per-node constant and ``res`` the
residual projection's output.  ``u`` holds the dropout's uniforms, drawn
by the model exactly as the plain chain draws its mask, so the kernel
keeps the reference's masks; it draws no bits of its own.

``layer_tail`` takes the kernels where it can observe that they apply
(``engages``): every tensor on the card, float32, the paths, ``const``,
``res`` and ``u`` contiguous with ``R * F`` elements (a flat ``[N, F]``
carry, or an rg ``[A, G, F]`` one, the same memory), the biases ``[F]``,
each gate ``R`` values with a last dim of 1, or one, and F at most 1,024
(256 where a load cannot take 16 bytes: ``launch_plan``).  Every other
input (CPU tensors, bf16 tiers, a packed rg carry) takes ``tail_plain``, the ATen
chain the model ran before, which is also the kernels' oracle; the model
hands no feature-sharded layer to it (the gather sits between the sum and
the activation), nor the literal or per-path-remat layers.  On the card a
call the rule takes launches the kernels or raises.

- Forward: one launch (``epilogue_fwd_kernel``), writing ``out`` and, when
  autograd records, a byte an element: the leaky ReLU's sign and the
  dropout's keep.  The forward's outputs equal the chain's to the bit.
- Backward: one launch (``epilogue_bwd_kernel``): the three paths'
  cotangents and ``ds`` (the gradient of ``const`` and of ``res``) to the
  bit, the five gates' per-row sums and the three biases' column sums in
  another order than ATen's reductions (deterministic all the same).

``forward_plain`` / ``backward_plain`` repeat the kernels' arithmetic in
PyTorch; on CPU tensors the wrappers run them where ``_on_card`` says
true (the tests' stand-in for the card).  ``LAUNCHES`` counts the
kernels' launches by direction.  Spans (``utils/profiling.py``, under a
profiler): the forward inside ``ops.epilogue``, the backward inside
``ops.epilogue_bwd``.
"""

from __future__ import annotations

import ctypes
import re
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from protgram_directgcn_torch.ops import _nvcc
from protgram_directgcn_torch.utils.profiling import trace

LAUNCHES: Dict[str, Dict[str, int]] = {"layer_tail": {"fwd": 0, "bwd": 0}}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
BUILD_INFO: Dict[str, object] = {}

# The kernels' bounds, read from the source that compiles them.
_BOUNDS = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                          (_nvcc.CSRC / "epilogue.cu").read_text()))
THREADS = int(_BOUNDS["kThreads"])
MAX_CHUNKS = int(_BOUNDS["kMaxChunks"])
BLOCKS_PER_SM = 2048 // THREADS  # the most an SM holds: the backward's partials

# Per device: the backward's counter (0 between launches).
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


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
            info = _nvcc.compile_source("epilogue")
            lib = ctypes.CDLL(str(info["path"]))
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.epilogue_fwd.argtypes = [ptr, ptr, i64, i32, i32, i32, f32, f32, f32, ptr]
        lib.epilogue_bwd.argtypes = [ptr, ptr, i64, i32, i32, i32, i32, i32, f32, f32, ptr]
        for fn in (lib.epilogue_fwd, lib.epilogue_bwd):
            fn.restype = i32
        BUILD_INFO.clear()
        BUILD_INFO.update(info)
        _lib = lib
        return BUILD_INFO


# -----------------------------------------------------------------------------
# Plain PyTorch versions
# -----------------------------------------------------------------------------


def combine_plain(gates: Sequence, ic, oc, uc, const):
    """Hierarchical gating and the per-node constant, each operand shaped
    to broadcast (reference combine: protgram_directgcn.py:131-135)."""
    c_in, c_out, c_dir, c_und, c_all = gates
    directed = c_dir * (c_in * ic + c_out * oc)
    undirected = c_und * uc
    return c_all * (undirected + directed) + const


def activate_plain(s: torch.Tensor, slope: float, keep: float,
                   u: Optional[torch.Tensor]) -> torch.Tensor:
    """Leaky ReLU, then inverted dropout keeping where ``u < keep`` (no
    dropout where ``u`` is None)."""
    out = F.leaky_relu(s, negative_slope=slope)
    if u is None:
        return out
    return torch.where(u < keep, out / keep, torch.zeros((), dtype=out.dtype, device=out.device))


def tail_plain(pi, po, pu, b_in, b_out, b_und, gates: Sequence, const, res, slope: float,
               keep: float, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ATen chain: bias adds, gating and constant, residual, activation
    (the gates and ``const`` shaped to broadcast against the paths)."""
    s = combine_plain(gates, pi + b_in, po + b_out, pu + b_und, const) + res
    return activate_plain(s, slope, keep, u)


def inverse_keep(keep: float) -> float:
    """ATen's factor for a float32 tensor divided by the scalar ``keep`` on
    the card: ``1 / keep`` taken in float32."""
    return float(np.float32(1.0) / np.float32(keep))


def forward_plain(pi, po, pu, b_in, b_out, b_und, gates: Sequence, const, res, slope: float,
                  keep: float, u: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic on ``[R, F]`` operands and ``[R]``
    or ``[1]`` gates: (out, code), code = (s > 0) | (u < keep) << 1."""
    c_in, c_out, c_dir, c_und, c_all = (g[:, None] for g in gates)
    t = c_in * (pi + b_in) + c_out * (po + b_out)
    s = (c_all * (c_und * (pu + b_und) + c_dir * t) + const) + res
    pos = s > 0
    act = torch.where(pos, s, s * slope)
    if u is None:
        kept = torch.ones_like(pos)
        out = act
    else:
        kept = u < keep
        out = torch.where(kept, act * inverse_keep(keep), torch.zeros((), dtype=s.dtype))
    return out, pos.to(torch.uint8) | (kept.to(torch.uint8) << 1)


def backward_plain(dout, code, pi, po, pu, b_in, b_out, b_und, gates: Sequence, slope: float,
                   inv_keep: float):
    """The backward kernel's arithmetic: (d_pi, d_po, d_pu, ds, d_gate
    [5, R], d_bias [3, F])."""
    c_in, c_out, c_dir, c_und, c_all = (g[:, None] for g in gates)
    zero = torch.zeros((), dtype=dout.dtype)
    g = torch.where((code & 2).bool(), dout * inv_keep, zero)
    ds = torch.where((code & 1).bool(), g, g * slope)
    ic, oc, uc = pi + b_in, po + b_out, pu + b_und
    t = c_in * ic + c_out * oc
    m = c_und * uc + c_dir * t
    e = ds * c_all
    f = e * c_dir
    d_pi, d_po, d_pu = f * c_in, f * c_out, e * c_und
    d_gate = torch.stack([(f * ic).sum(1), (f * oc).sum(1), (e * t).sum(1), (e * uc).sum(1),
                          (ds * m).sum(1)])
    d_bias = torch.stack([d_pi.sum(0), d_po.sum(0), d_pu.sum(0)])
    return d_pi, d_po, d_pu, ds, d_gate, d_bias


# -----------------------------------------------------------------------------
# The route and the launches
# -----------------------------------------------------------------------------


class Plan(NamedTuple):
    vec: int  # elements a load: 4 (16 bytes) or 1
    lanes: int  # lanes a row, a power of two <= 32
    chunks: int  # vectors of a row a lane holds (the backward's registers)


def launch_plan(f: int, aligned: bool) -> Optional[Plan]:
    """The geometry for width ``f``: 16 bytes a load where ``f % 4 == 0``
    and every pointer is aligned; None where a lane would hold more than
    ``MAX_CHUNKS`` vectors of a row (F > 1,024, or F > 256 one element a load)."""
    vec = 4 if aligned and f % 4 == 0 else 1
    vecs = -(-f // vec)
    lanes = min(32, 1 << (vecs - 1).bit_length())
    chunks = 1 << (-(-vecs // lanes) - 1).bit_length()
    return Plan(vec, lanes, chunks) if chunks <= MAX_CHUNKS else None


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def _aligned(ts: Sequence[torch.Tensor]) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def engages(pi, po, pu, b_in, b_out, b_und, gates: Sequence, const, res,
            u: Optional[torch.Tensor]) -> bool:
    """Whether ``layer_tail`` takes the kernels for these operands (see the
    module's docstring)."""
    if not isinstance(const, torch.Tensor) or not _on_card(pi):
        return False
    carry = [pi, po, pu, const, res] + ([u] if u is not None else [])
    f = pi.shape[-1] if pi.dim() else 0
    rows = pi.numel() // f if f else 0
    biases = [b_in, b_out, b_und]
    tensors = carry + biases + list(gates)
    if any(t.dtype != torch.float32 or t.device != pi.device or not t.is_contiguous()
           for t in tensors):
        return False
    if f == 0 or pi.dim() not in (2, 3) or launch_plan(f, _aligned(carry + biases)) is None:
        return False
    if any(t.shape != pi.shape for t in (po, pu, res) + ((u,) if u is not None else ())):
        return False
    if const.numel() != pi.numel() or const.shape[-1] != f:
        return False
    if any(tuple(b.shape) != (f,) for b in (b_in, b_out, b_und)):
        return False
    return all(tuple(g.shape) == (1,) or (g.numel() == rows and g.shape[-1] == 1 and g.dim() > 1)
               for g in gates)


def _gate_rows(gates: Sequence[torch.Tensor]) -> np.ndarray:
    """1 for a flat gate of one value a row, 0 for a scalar one."""
    return np.array([g.numel() != 1 for g in gates], dtype=np.int32)


def _counter(dev: torch.device) -> torch.Tensor:
    if dev not in _COUNTERS:
        _COUNTERS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _COUNTERS[dev]


def _forward(pi, po, pu, b_in, b_out, b_und, gates, const, res, slope: float, keep: float,
             u: Optional[torch.Tensor], keep_code: bool):
    """(out, code or None) on ``[R, F]`` operands and flat gates."""
    LAUNCHES["layer_tail"]["fwd"] += 1
    if not pi.is_cuda:
        out, code = forward_plain(pi, po, pu, b_in, b_out, b_und, gates, const, res, slope,
                                  keep, u)
        return out, (code if keep_code else None)
    if _lib is None:
        build()
    rows, f = pi.shape
    out = torch.empty_like(pi)
    code = torch.empty((rows, f), dtype=torch.uint8, device=pi.device) if keep_code else None
    streams = [pi, po, pu, b_in, b_out, b_und, const, res, out] + ([u] if u is not None else [])
    plan = launch_plan(f, _aligned(streams))
    ins = [pi, po, pu, b_in, b_out, b_und, *gates, const, res]
    ptrs = np.array([t.data_ptr() for t in ins]
                    + [u.data_ptr() if u is not None else 0, out.data_ptr(),
                       code.data_ptr() if code is not None else 0], dtype=np.int64)
    gate_rows = _gate_rows(gates)  # held while the call reads it
    rc = _lib.epilogue_fwd(ptrs.ctypes.data, gate_rows.ctypes.data, rows, f, plan.vec,
                           plan.lanes, slope, float(np.float32(keep)), inverse_keep(keep),
                           _nvcc.stream_ptr(pi))
    _nvcc.raise_on(rc, "epilogue_fwd")
    return out, code


def _backward(dout, code, pi, po, pu, b_in, b_out, b_und, gates, slope: float, inv_keep: float):
    """(d_pi, d_po, d_pu, ds, d_gate [5, R], d_bias [3, F])."""
    LAUNCHES["layer_tail"]["bwd"] += 1
    if not pi.is_cuda:
        return backward_plain(dout, code, pi, po, pu, b_in, b_out, b_und, gates, slope,
                              inv_keep)
    rows, f = pi.shape
    dev = pi.device
    if dout.data_ptr() % 16:  # a fresh copy is aligned, as the forward's operands were
        dout = dout.clone()
    outs = [torch.empty_like(pi) for _ in range(4)]
    d_gate = torch.empty((5, rows), dtype=torch.float32, device=dev)
    max_blocks = torch.cuda.get_device_properties(dev).multi_processor_count * BLOCKS_PER_SM
    partials = torch.empty((max_blocks, 3, f), dtype=torch.float32, device=dev)
    d_bias = torch.empty((3, f), dtype=torch.float32, device=dev)
    ins = [pi, po, pu, b_in, b_out, b_und, *gates]
    plan = launch_plan(f, _aligned([pi, po, pu, b_in, b_out, b_und, dout] + outs))
    ptrs = np.array([t.data_ptr() for t in ins + [dout, code, *outs, d_gate, partials,
                                                  _counter(dev), d_bias]], dtype=np.int64)
    gate_rows = _gate_rows(gates)
    rc = _lib.epilogue_bwd(ptrs.ctypes.data, gate_rows.ctypes.data, rows, f, plan.vec,
                           plan.lanes, plan.chunks, max_blocks, slope, inv_keep,
                           _nvcc.stream_ptr(pi))
    _nvcc.raise_on(rc, "epilogue_bwd")
    return (*outs, d_gate, d_bias)


class _LayerTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pi, po, pu, b_in, b_out, b_und, c_in, c_out, c_dir, c_und, c_all, const,
                res, slope, keep, u):
        gates = (c_in, c_out, c_dir, c_und, c_all)
        with trace("ops.epilogue"):
            out, code = _forward(pi, po, pu, b_in, b_out, b_und, gates, const, res, slope,
                                 keep, u, keep_code=True)
        ctx.slope = slope
        ctx.inv_keep = 1.0 if u is None else inverse_keep(keep)
        ctx.save_for_backward(pi, po, pu, b_in, b_out, b_und, *gates, code)
        return out

    @staticmethod
    def backward(ctx, dout):
        pi, po, pu, b_in, b_out, b_und, *gates, code = ctx.saved_tensors
        with trace("ops.epilogue_bwd"):
            d_pi, d_po, d_pu, ds, d_gate, d_bias = _backward(
                dout.contiguous(), code, pi, po, pu, b_in, b_out, b_und, gates, ctx.slope,
                ctx.inv_keep)
            d_gates = [d_gate[k] if g.numel() == d_gate.shape[1] else d_gate[k].sum().reshape(1)
                       for k, g in enumerate(gates)]
        return (d_pi, d_po, d_pu, d_bias[0], d_bias[1], d_bias[2], *d_gates, ds, ds,
                None, None, None)


def layer_tail(pi, po, pu, b_in, b_out, b_und, gates: Sequence, const, res, slope: float,
               keep: float, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A layer's tail from its propagated paths to its activation (see the
    module's docstring): the kernels where ``engages``, else
    ``tail_plain``.  ``gates`` are shaped to broadcast against the paths
    (rg-viewed on an rg carry), ``u`` None for no dropout."""
    if not engages(pi, po, pu, b_in, b_out, b_und, gates, const, res, u):
        return tail_plain(pi, po, pu, b_in, b_out, b_und, gates, const, res, slope, keep, u)
    shape = pi.shape
    f = shape[-1]
    rows = pi.numel() // f
    flat = [t.reshape(rows, f) for t in (pi, po, pu)]
    flat_gates = [g.reshape(-1) for g in gates]
    const, res = const.reshape(rows, f), res.reshape(rows, f)
    u = u.reshape(rows, f) if u is not None else None
    operands = (*flat, b_in, b_out, b_und, *flat_gates, const, res)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        out = _LayerTail.apply(*operands, slope, keep, u)
    else:
        with trace("ops.epilogue"):
            out, _ = _forward(*flat, b_in, b_out, b_und, flat_gates, const, res, slope, keep, u,
                              keep_code=False)
    return out.reshape(shape)
