"""Port parity: the link-prediction MLP (``protgram_directgcn_torch/models/mlp.py``).

- The JAX package's initial parameters carried over by
  ``convert.mlp_params_from_jax``: equal, leaf for leaf.
- Logits and probabilities in eval mode against ``mlp_logits`` on the same
  parameters and inputs: rtol 1e-5, atol 1e-6.
- Three Adam steps (dropout 0, with and without class weights, L2 on) from
  the same parameters against the JAX ``MLPTrainer``: the epoch loss and
  every parameter at rtol 1e-5 (atol 1e-7).
- The port's own init (Glorot bounds, zero biases, one seed one draw) and
  dropout in training mode only.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from protgram_directgcn_torch import convert
from protgram_directgcn_torch.models import mlp as t_mlp
from protgram_directgcn_tpu.models import mlp as j_mlp

DIM = 24


def _cfgs(dropout: float = 0.0, l2: float = 1e-3):
    kw = dict(input_dim=DIM, dense1_units=16, dropout1_rate=dropout, dense2_units=8,
              dropout2_rate=dropout, l2_reg=l2, learning_rate=1e-2)
    return j_mlp.MLPConfig(**kw), t_mlp.MLPConfig(**kw)


def _pair(seed: int, dropout: float = 0.0, l2: float = 1e-3):
    jc, tc = _cfgs(dropout, l2)
    jt = j_mlp.MLPTrainer(jc, seed=seed)
    tt = t_mlp.MLPTrainer(tc, seed=seed, device="cpu")
    tt.set_params(convert.mlp_params_from_jax(jt.params, device="cpu"))
    return jt, tt


def _batches(seed: int, n_batches: int = 3, size: int = 32):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(size, DIM)).astype(np.float16),
             (rng.random(size) < 0.3).astype(np.int32)) for _ in range(n_batches)]


@pytest.mark.parametrize("seed", [0, 42])
def test_converted_init_equals_jax(seed):
    jt, tt = _pair(seed)
    for name, value in tt.params.items():
        np.testing.assert_array_equal(value.detach().numpy(), np.asarray(jt.params[name]))
        assert value.dtype == torch.float32


@pytest.mark.parametrize("seed", [1, 7])
def test_eval_logits_match_jax(seed):
    jt, tt = _pair(seed, dropout=0.4)
    x = np.random.default_rng(seed).normal(size=(50, DIM)).astype(np.float32)
    want = np.asarray(j_mlp.mlp_logits(jt.params, x, jt.cfg))
    tt.model.eval()
    got = tt.model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.predict_proba(x), jt.predict_proba(x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("class_weight", [None, {0: 0.7, 1: 1.9}])
@pytest.mark.parametrize("seed", [3, 11])
def test_three_adam_steps_match_jax(seed, class_weight):
    jt, tt = _pair(seed)
    batches = _batches(seed)
    want = jt.fit_epoch(iter(batches), class_weight)
    got = tt.fit_epoch(iter(batches), class_weight)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tt.steps == 3
    for name, value in tt.params.items():
        np.testing.assert_allclose(value.detach().numpy(), np.asarray(jt.params[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    # A second epoch from there, as tensor batches.
    tensors = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches]
    np.testing.assert_allclose(tt.fit_epoch(iter(tensors), class_weight),
                               jt.fit_epoch(iter(batches), class_weight), rtol=1e-5)


def test_own_init_and_dropout():
    _, tc = _cfgs(dropout=0.5)
    a, b = t_mlp.init_mlp_params(5, tc), t_mlp.init_mlp_params(5, tc)
    for name in a:
        assert torch.equal(a[name], b[name])
    limit = (6.0 / (DIM + 16)) ** 0.5
    assert a["w1"].abs().max() <= limit and a["w1"].abs().max() > 0.9 * limit
    assert not a["b1"].any() and not a["b3"].any()
    assert not torch.equal(a["w1"], t_mlp.init_mlp_params(6, tc)["w1"])
    tt = t_mlp.MLPTrainer(tc, seed=5, device="cpu")
    x = torch.randn(64, DIM, generator=torch.Generator().manual_seed(0))
    tt.model.train()
    assert not torch.equal(tt.model(x, tt.gen), tt.model(x, tt.gen))
    tt.model.eval()
    assert torch.equal(tt.model(x, tt.gen), tt.model(x))
    # No dropout rate: training mode computes the eval logits.
    t0 = t_mlp.MLPTrainer(dataclasses.replace(tc, dropout1_rate=0.0, dropout2_rate=0.0),
                          seed=5, device="cpu")
    t0.model.train()
    assert torch.equal(t0.model(x, t0.gen), tt.model(x))


def test_loss_is_optax_sigmoid_bce():
    import optax

    logits = np.linspace(-30, 30, 41).astype(np.float32)
    labels = (np.arange(41) % 2).astype(np.float32)
    want = np.asarray(optax.sigmoid_binary_cross_entropy(logits, labels))
    got = t_mlp.sigmoid_binary_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert jax.numpy.isfinite(want).all()
