"""Segment operations over edges (the zoo's attention softmax).

Port of protgram_directgcn_tpu/ops/segment.py: per-edge values normalised
over each target node's incoming edges, on ``scatter_reduce`` and
``index_add_``.
"""

from __future__ import annotations

import torch


def _segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, segment_ids, values)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax over segments (axis 0).  An empty
    segment's maximum is 0, as ``jnp.where(isfinite)`` makes it; the
    maximum is a constant shift, so no gradient flows through it."""
    ids = segment_ids.long()
    idx = ids.view((-1,) + (1,) * (logits.dim() - 1)).expand_as(logits)
    maxs = logits.new_full((num_segments,) + tuple(logits.shape[1:]), float("-inf"))
    maxs = maxs.scatter_reduce(0, idx, logits.detach(), "amax", include_self=False)
    maxs = torch.where(torch.isfinite(maxs), maxs, torch.zeros_like(maxs))
    exp = torch.exp(logits - maxs[ids])
    sums = _segment_sum(exp, ids, num_segments)
    return exp / torch.clamp(sums[ids], min=1e-16)


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    ids = segment_ids.long()
    sums = _segment_sum(values, ids, num_segments)
    counts = _segment_sum(torch.ones(ids.shape, dtype=values.dtype, device=values.device), ids,
                          num_segments)
    return sums / torch.clamp(counts, min=1.0).view((-1,) + (1,) * (values.dim() - 1))
