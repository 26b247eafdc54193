"""Port parity: ``ops/segment.py`` against the JAX package's.

The same seeded logits and segment ids through ``segment_softmax`` and
``segment_mean`` of both packages, float32, empty segments included (an
empty segment's maximum maps to 0, its mean to 0): rtol 1e-6, atol 1e-7.
The gradient of a weighted sum of the softmax, within rtol 1e-5, atol
1e-6 * max|gradient| (the port takes no gradient through the constant
shift, whose terms JAX adds and cancels in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protgram_directgcn_torch.ops import segment as t_seg
from protgram_directgcn_tpu.ops import segment as j_seg


def _case(seed, n_edges, num_segments, trailing):
    rng = np.random.default_rng(seed)
    # Segments 0 and num_segments-1 are left empty.
    ids = rng.integers(1, num_segments - 1, n_edges).astype(np.int32)
    vals = (rng.normal(size=(n_edges,) + trailing) * 5).astype(np.float32)
    return ids, vals


@pytest.mark.parametrize("seed,n_edges,num_segments,trailing",
                         [(0, 50, 12, ()), (1, 200, 30, (8,)), (2, 64, 5, (3, 4)),
                          (3, 1, 3, (2,))])
def test_segment_softmax_matches_jax(seed, n_edges, num_segments, trailing):
    ids, vals = _case(seed, n_edges, num_segments, trailing)
    want = np.asarray(j_seg.segment_softmax(jnp.asarray(vals), jnp.asarray(ids), num_segments))
    got = t_seg.segment_softmax(torch.from_numpy(vals), torch.from_numpy(ids), num_segments)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    sums = np.zeros((num_segments,) + trailing, np.float64)
    np.add.at(sums, ids, got.numpy())
    present = np.unique(ids)
    np.testing.assert_allclose(sums[present], 1.0, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_softmax_gradient_matches_jax(seed):
    ids, vals = _case(seed, 120, 16, (4,))
    weights = np.random.default_rng(seed + 100).normal(size=vals.shape).astype(np.float32)

    def j_loss(v):
        return jnp.sum(j_seg.segment_softmax(v, jnp.asarray(ids), 16) * weights)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(vals)))
    v = torch.from_numpy(vals).requires_grad_(True)
    (t_seg.segment_softmax(v, torch.from_numpy(ids), 16) * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_segment_softmax_empty_segment_max_is_zero():
    """All-empty but one segment, logits far from 0: stable, and no NaN."""
    ids = np.array([2, 2, 2], np.int32)
    vals = np.array([1000.0, 999.0, -5.0], np.float32)
    got = t_seg.segment_softmax(torch.from_numpy(vals), torch.from_numpy(ids), 4).numpy()
    want = np.asarray(j_seg.segment_softmax(jnp.asarray(vals), jnp.asarray(ids), 4))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed,n_edges,num_segments,trailing",
                         [(0, 50, 12, ()), (1, 200, 30, (8,)), (2, 64, 5, (3, 4))])
def test_segment_mean_matches_jax(seed, n_edges, num_segments, trailing):
    ids, vals = _case(seed, n_edges, num_segments, trailing)
    want = np.asarray(j_seg.segment_mean(jnp.asarray(vals), jnp.asarray(ids), num_segments))
    got = t_seg.segment_mean(torch.from_numpy(vals), torch.from_numpy(ids), num_segments)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert (got.numpy()[[0, num_segments - 1]] == 0).all()
