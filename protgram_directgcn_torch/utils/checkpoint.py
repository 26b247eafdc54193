"""Training-state checkpoints inside a level, and their resume.

Port of protgram_directgcn_tpu/utils/checkpoint.py, with ``torch.save`` in
place of orbax.  The per-level ``level_{n}.npz`` embeddings stay the coarse
recovery boundary (pipeline/trainer.py); these are the fine one: every
``gcn.checkpoint_every_epochs`` epochs the full-batch loop saves
``step_{epoch}`` in the level's directory, holding the parameters, the
optimizer's state (Adam moments, factored Adafactor row and column moments,
step counts) and its learning rate, and ``extra`` (the trainer's dropout
generator).  A restart restores the latest one before its first epoch.

The parameters and each leaf's state are stored in the order of
``models.directgcn.param_leaves``, so a checkpoint restores into any
parameter tree of the same shapes and types.  The state tensors keep their
own type (float32 moments over bfloat16 parameters), which
``torch.optim.Optimizer.load_state_dict`` would cast to the parameter's.

On a node-sharded level (``shard``: the trainer's ``NodeShard``) the file
holds the whole level's state: every rank's node rows of the node leaves and
of their state are gathered, rank 0 writes them, and each rank restores its
own rows.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from protgram_directgcn_torch.models.directgcn import named_leaves
from protgram_directgcn_torch.utils.io import logger


def _cpu(v):
    return v.detach().cpu() if isinstance(v, torch.Tensor) else v


def save_train_state(ckpt_dir: os.PathLike, step: int, params: Any,
                     opt: torch.optim.Optimizer, extra: Optional[Dict[str, Any]] = None,
                     shard: Any = None) -> str:
    """Save (params, optimizer state, ``extra``) at ``step``; returns the
    checkpoint's path.  Written to a temporary name and renamed, so a cut
    run leaves no partial ``step_{k}``.  With ``shard``, every rank must
    call it (the gathers are collective) and rank 0 writes."""
    path = os.path.join(os.path.abspath(str(ckpt_dir)), f"step_{step}")

    def whole(name, p, key=None, v=None):
        t = p if key is None else v
        if (shard is not None and isinstance(t, torch.Tensor) and shard.is_node(name, p)
                and (key is None or shard.state_is_node(key, p))):
            t = shard.gather(t)
        return _cpu(t)

    leaves = named_leaves(params)
    state = {
        "step": int(step),
        "params": [whole(n, p) for n, p in leaves],
        "opt_state": [{k: whole(n, p, k, v) for k, v in opt.state[p].items()}
                      if p in opt.state else {} for n, p in leaves],
        "lr": [group["lr"] for group in opt.param_groups],
        "extra": {k: _cpu(v) for k, v in (extra or {}).items()},
    }
    if shard is not None and not shard.is_main:
        return path
    os.makedirs(str(ckpt_dir), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: os.PathLike) -> Optional[int]:
    """The largest k of the ``step_{k}`` checkpoints in ``ckpt_dir``."""
    if not os.path.isdir(str(ckpt_dir)):
        return None
    steps = []
    for name in os.listdir(str(ckpt_dir)):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_train_state(ckpt_dir: os.PathLike, params: Any, opt: torch.optim.Optimizer,
                        shard: Any = None) -> Optional[Tuple[int, Dict[str, Any]]]:
    """Restore the latest checkpoint into ``params`` (in place) and ``opt``;
    returns (step, extra), or None where there is none or it does not fit
    these parameters (then nothing is changed and a warning is logged).
    With ``shard``, each rank takes its rows of the node leaves."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    path = os.path.join(os.path.abspath(str(ckpt_dir)), f"step_{step}")
    named = named_leaves(params)
    leaves = [p for _, p in named]

    def own(name, p, t, key=None):
        if (shard is not None and isinstance(t, torch.Tensor) and shard.is_node(name, p)
                and (key is None or shard.state_is_node(key, p))):
            return shard.slab(t)
        return t

    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
        saved = [own(n, p, t) for (n, p), t in zip(named, state["params"])]
        state["opt_state"] = [{k: own(n, p, v, k) for k, v in st.items()}
                              for (n, p), st in zip(named, state["opt_state"])]
        if len(saved) != len(leaves) or len(state["lr"]) != len(opt.param_groups) or any(
                s.shape != p.shape or s.dtype != p.dtype for s, p in zip(saved, leaves)):
            raise ValueError("parameter shapes or types differ from the checkpoint's")
    except Exception as exc:
        logger.warning("checkpoint restore failed at %s: %s", path, exc)
        return None
    with torch.no_grad():
        for p, s in zip(leaves, saved):
            p.copy_(s)
    for p, st in zip(leaves, state["opt_state"]):
        opt.state.pop(p, None)
        if st:
            opt.state[p] = {k: v.to(p.device) if isinstance(v, torch.Tensor) else v
                            for k, v in st.items()}
    for group, lr in zip(opt.param_groups, state["lr"]):
        group["lr"] = lr
    logger.info("restored training state from %s", path)
    return int(state["step"]), state["extra"]
