"""Link-prediction MLP: the evaluation head of the PPI tasks.

Port of protgram_directgcn_tpu/models/mlp.py:21-117 (reference:
src/models/mlp.py:39-73): Dense(relu) -> Dropout -> Dense(relu) -> Dropout
-> Dense(1), trained by Adam (optax's defaults and float32 arithmetic,
``OptaxAdam``) on a class-weighted sigmoid cross entropy plus L2 on the
three weight matrices.  Glorot-uniform weights
and zero biases are drawn on the host from a ``torch.Generator`` seeded by
``seed`` and moved to the device, so the card and the CPU start from the
same parameters; dropout masks come from a generator on the device seeded
by ``seed + 1``.

``fit_epoch`` sums the loss on the device and reads it once an epoch: a
step launches its kernels and returns without waiting for the card.
Batches may be numpy arrays (moved to the device a batch at a time) or
tensors already on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from protgram_directgcn_torch.utils.device import resolve_device

Array = Union[np.ndarray, torch.Tensor]


@dataclass(frozen=True)
class MLPConfig:
    input_dim: int
    dense1_units: int = 128
    dropout1_rate: float = 0.4
    dense2_units: int = 64
    dropout2_rate: float = 0.4
    l2_reg: float = 1e-5
    learning_rate: float = 1e-3


def _glorot(gen: torch.Generator, shape) -> torch.Tensor:
    limit = (6.0 / (shape[0] + shape[1])) ** 0.5
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (2 * limit) - limit


def init_mlp_params(seed: int, cfg: MLPConfig) -> Dict[str, torch.Tensor]:
    """Host float32 parameters ``w1, b1, w2, b2, w3, b3`` (jax's layout:
    ``x @ w + b``)."""
    gen = torch.Generator().manual_seed(seed)
    return {
        "w1": _glorot(gen, (cfg.input_dim, cfg.dense1_units)),
        "b1": torch.zeros(cfg.dense1_units),
        "w2": _glorot(gen, (cfg.dense1_units, cfg.dense2_units)),
        "b2": torch.zeros(cfg.dense2_units),
        "w3": _glorot(gen, (cfg.dense2_units, 1)),
        "b3": torch.zeros(1),
    }


class MLP(torch.nn.Module):
    """The head as a module: parameters named as in the JAX package."""

    def __init__(self, cfg: MLPConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name, value in params.items():
            self.register_parameter(name, torch.nn.Parameter(value))

    def _dropout(self, h: torch.Tensor, rate: float, gen: Optional[torch.Generator]):
        if not self.training or gen is None or rate <= 0:
            return h
        keep = 1.0 - rate
        mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
        return torch.where(mask, h / keep, 0.0)

    def forward(self, x: torch.Tensor, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[B]``; dropout only in training mode with a generator."""
        h = self._dropout(torch.relu(x @ self.w1 + self.b1), self.cfg.dropout1_rate, gen)
        h = self._dropout(torch.relu(h @ self.w2 + self.b2), self.cfg.dropout2_rate, gen)
        return (h @ self.w3 + self.b3)[:, 0]


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def adam_bias_corrections(count: int) -> Tuple[float, float]:
    """optax ``scale_by_adam``'s bias corrections ``1 - b1**t`` and
    ``1 - b2**t`` at step ``t = count``, computed in float32 as optax computes
    them on float32 leaves (float64's differ by ~1e-5 relative at the first
    steps: ``1 - 0.999**1`` is 1.3e-5 off).  Every Adam of the port takes
    them from here."""
    t = np.float32(count)
    return (float(np.float32(1) - np.float32(OptaxAdam.B1) ** t),
            float(np.float32(1) - np.float32(OptaxAdam.B2) ** t))


class OptaxAdam(torch.optim.Optimizer):
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8) as optax computes it
    on float32 leaves: the bias corrections of :func:`adam_bias_corrections`,
    then ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by ``-lr`` and added.
    ``weight_decay`` > 0 makes it ``optax.chain(add_decayed_weights(wd),
    adam(lr))``: ``g + wd * p`` takes the gradient's place.  One
    ``torch._foreach_*`` launch per operation for all leaves."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, lr: float, weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "weight_decay": weight_decay, "count": 0})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            group["count"] += 1
            bc1, bc2 = adam_bias_corrections(group["count"])
            grads = [p.grad for p in ps]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, ps, alpha=group["weight_decay"])
            mus = [self.state[p]["mu"] for p in ps]
            nus = [self.state[p]["nu"] for p in ps]
            torch._foreach_mul_(mus, self.B1)
            torch._foreach_add_(mus, grads, alpha=1 - self.B1)
            torch._foreach_mul_(nus, self.B2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - self.B2)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.EPS)
            update = torch._foreach_div(mus, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(ps, update, alpha=-group["lr"])


class MLPTrainer:
    """Mini-batch Adam training over (features, labels) batch iterators."""

    def __init__(self, cfg: MLPConfig, seed: int = 42, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = MLP(cfg, {k: v.to(self.device) for k, v in init_mlp_params(seed, cfg).items()})
        self.opt = OptaxAdam(self.model.parameters(), lr=cfg.learning_rate)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.steps = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def set_params(self, params: Dict[str, Array]) -> None:
        """Overwrite the parameters (e.g. with ``convert.mlp_params_from_jax``)."""
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                value = params[name]
                if not isinstance(value, torch.Tensor):
                    value = torch.from_numpy(np.asarray(value, np.float32))
                p.copy_(value)

    def _tensor(self, a: Array) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(self.device)

    def _loss(self, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        logits = self.model(x, self.gen)
        bce = sigmoid_binary_cross_entropy(logits, y)
        primary = torch.sum(bce * w) / torch.clamp(torch.sum(w), min=1e-8)
        m = self.model
        l2 = self.cfg.l2_reg * (torch.sum(m.w1 ** 2) + torch.sum(m.w2 ** 2) + torch.sum(m.w3 ** 2))
        return primary + l2

    def fit_epoch(self, batches: Iterable[Tuple[Array, Array]],
                  class_weight: Optional[Dict[int, float]] = None) -> float:
        """One pass over ``batches``; returns the mean of the steps' losses
        (the only read from the device)."""
        self.model.train()
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        count = 0
        cw0 = class_weight.get(0, 1.0) if class_weight else 1.0
        cw1 = class_weight.get(1, 1.0) if class_weight else 1.0
        for x_b, y_b in batches:
            x, y = self._tensor(x_b), self._tensor(y_b)
            w = torch.where(y > 0, cw1, cw0) if class_weight else torch.ones_like(y)
            loss = self._loss(x, y, w)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
            self.opt.step()
            total += loss.detach()
            count += 1
        self.steps += count
        return float(total) / max(count, 1)

    @torch.no_grad()
    def predict_proba_tensor(self, x: Array) -> torch.Tensor:
        """Probabilities ``[B]`` on the device (eval mode, no dropout)."""
        self.model.eval()
        return torch.sigmoid(self.model(self._tensor(x)))

    def predict_proba(self, x: Array) -> np.ndarray:
        return self.predict_proba_tensor(x).cpu().numpy()
