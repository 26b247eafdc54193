"""The process group and the collectives the sharded operators use.

Port of protgram_directgcn_tpu/parallel/distributed.py.  The JAX package
runs one controller over a mesh of devices and lets GSPMD insert the
collectives; the port runs one process per device (``torchrun``), each rank
owning a node block, and the collectives are called here by hand.

``initialize_distributed`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/
``MASTER_PORT``) or explicit arguments.  Backend: NCCL where each rank has a
card of its own, gloo on the CPU and where ranks share a card (NCCL refuses
two ranks on one device).  Where the JAX package logs a failed start and
carries on in one process, this raises: a rank that carried on alone would
train the whole level and race the others for the output files.

Every collective takes an optional process ``group`` (None: the world), so
that a 2-D rank grid (``mesh.make_mesh``: node shards x feature shards) runs
its node-axis exchanges within one feature column of ranks and its
feature-axis reductions within one node shard; ``new_group`` makes and
keeps such groups.  The exchange layer calls ``all_to_all_single``,
``all_reduce`` and ``all_gather`` only: gloo takes CUDA tensors for those (it copies them
through host memory itself), and aborts the process on a
``batch_isend_irecv`` of CUDA tensors (``chip_smoke.py``'s probe on an
NVIDIA H100, PERF.md), so a ring of point-to-point steps is one ``all_to_all_single``.
``EXCHANGE`` counts the exchanges (all-to-alls and the gspmd mode's
all-gathers, whatever their group) and their bytes, and under
``TIME_EXCHANGES`` their seconds on the host clock with the device
synchronised around each one.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from protgram_directgcn_torch.utils.io import logger

EXCHANGE = {"calls": 0, "bytes": 0, "seconds": 0.0}
TIME_EXCHANGES = False


def reset_exchange_stats() -> None:
    EXCHANGE.update(calls=0, bytes=0, seconds=0.0)


def _int_env(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return int(val) if val not in (None, "") else None


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device: str = "cuda",
                           backend: Optional[str] = None,
                           timeout_seconds: float = 1800.0) -> bool:
    """Start the process group when run under a launcher; True when a group
    is up (started here or before).  Without a world size in the arguments
    or ``WORLD_SIZE``, a single-process run: returns False.  ``device``:
    the device type the ranks train on ("cuda" or "cpu"), which picks the
    backend unless ``backend`` is given.  Raises RuntimeError when the
    group cannot start."""
    if dist.is_available() and dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else _int_env("WORLD_SIZE")
    if world_size is None:
        logger.info("single-process run (no WORLD_SIZE)")
        return False
    rank = rank if rank is not None else (_int_env("RANK") or 0)
    local_rank = _int_env("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_world = _int_env("LOCAL_WORLD_SIZE") or world_size
    if init_method is None:
        init_method = "env://" if os.environ.get("MASTER_ADDR") else None
    if init_method is None:
        raise RuntimeError("initialize_distributed: WORLD_SIZE is set but neither an "
                           "init_method nor MASTER_ADDR/MASTER_PORT is")
    if backend is None:
        if device == "cuda":
            cards = torch.cuda.device_count()
            backend = "nccl" if cards >= local_world else "gloo"
            if backend == "gloo":
                logger.warning("%d ranks on this host share %d card(s): gloo backend",
                               local_world, cards)
        else:
            backend = "gloo"
    if device == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    try:
        dist.init_process_group(backend=backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_seconds))
    except Exception as exc:
        raise RuntimeError(f"torch.distributed initialisation failed (rank {rank} of "
                           f"{world_size}, backend {backend}): {exc}") from exc
    logger.info("torch.distributed: rank %d/%d, backend %s", rank, world_size, backend)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


_GROUPS: Dict[Tuple[int, ...], Any] = {}


def new_group(ranks: Sequence[int]) -> Any:
    """The process group of ``ranks`` (None for the whole world), made once
    and kept.  Every rank must call it with the same ranks in the same order
    (``dist.new_group`` is collective), members or not."""
    ranks = tuple(sorted(int(r) for r in ranks))
    if not is_initialized() or len(ranks) == world_size():
        return None
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def group_size(group: Any = None) -> int:
    """The ranks in ``group`` (None: the world); 1 outside a process group."""
    if not is_initialized():
        return 1
    return dist.get_world_size(group) if group is not None else dist.get_world_size()


def _count(t: torch.Tensor, t0: float) -> None:
    if TIME_EXCHANGES and t.is_cuda:
        torch.cuda.synchronize(t.device)
    EXCHANGE["calls"] += 1
    EXCHANGE["bytes"] += t.numel() * t.element_size()
    EXCHANGE["seconds"] += time.monotonic() - t0


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bfloat16 crosses a gloo group as its bits, viewed float16 (gloo's
    CUDA all-to-all refuses int16: "Invalid scalar type")."""
    return t.view(torch.float16) if t.dtype == torch.bfloat16 and backend() == "gloo" else t


def all_to_all(send: torch.Tensor, out_splits: Optional[Sequence[int]] = None,
               in_splits: Optional[Sequence[int]] = None, group: Any = None) -> torch.Tensor:
    """``all_to_all_single`` on rows within ``group``: its p-th rank gets
    ``send``'s ``in_splits[p]`` rows (equal shares when None), and the
    result holds ``out_splits[q]`` rows from each rank q in group order.
    Outside a process group: ``send``."""
    if not is_initialized():
        return send
    t0 = time.monotonic()
    if TIME_EXCHANGES and send.is_cuda:
        torch.cuda.synchronize(send.device)
    rows = send.shape[0] if out_splits is None else int(sum(out_splits))
    send = send.contiguous()
    out = send.new_empty((rows,) + tuple(send.shape[1:]))
    dist.all_to_all_single(_wire(out), _wire(send),
                           None if out_splits is None else list(out_splits),
                           None if in_splits is None else list(in_splits), group=group)
    _count(send, t0)
    return out


def all_reduce_sum(t: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group``, in place; returns it."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group: Any = None, count: bool = False) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes) in ``group``, in group order.
    ``count``: an exchange of the propagation (``EXCHANGE``)."""
    size = group_size(group)
    if size == 1:
        return [t]
    t0 = time.monotonic()
    if count and TIME_EXCHANGES and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather([_wire(o) for o in outs], _wire(t), group=group)
    if count:
        _count(t, t0)
    return outs
