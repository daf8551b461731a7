"""TrainableAttention: explicit forward / backward / update over any
registered mechanism (port of ruvector_tpu/attention/trainable.py).

The reference's trait with hand-written backward passes and a Gradients
struct; here the backward is torch.autograd, the update the port's Adam
(training/optimizers.adam, optax's rules) with its state carried on the
object.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ruvector_tpu_torch.attention.base import get_attention
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.training.optimizers import (
    adam,
    apply_updates,
    tree_leaves,
    tree_unflatten,
)


@dataclasses.dataclass
class Gradients:
    """Gradient tree and its scalar statistics."""

    grads: Any
    loss: float
    grad_norm: float


class TrainableAttention:
    """A registered mechanism with forward, backward (MSE to a target) and
    an Adam update. Parameters from the mechanism's init on `device`."""

    def __init__(self, name: str, config: Any = None, seed: int = 0,
                 learning_rate: float = 1e-3, device=None):
        self.device = resolve_device(device)
        self.mech = get_attention(name)
        self.config = config if config is not None else self.mech.default_config
        self.params = (self.mech.init(seed, self.config, self.device)
                       if self.mech.init is not None else None)
        self.opt = adam(learning_rate)
        self.opt_state = self.opt.init(self.params) if self.params is not None else None

    def _tensors(self, *xs) -> list[torch.Tensor]:
        """Array-likes (numpy, as the JAX package accepts) as float32
        tensors on the mechanism's device; tensors as they are."""
        return [x if isinstance(x, torch.Tensor)
                else torch.as_tensor(np.asarray(x, np.float32), device=self.device) for x in xs]

    def _loss(self, params, q, k, v, target) -> torch.Tensor:
        out = self.mech.apply(params, self.config, *self._tensors(q, k, v))
        return torch.mean((out - self._tensors(target)[0]) ** 2)

    def forward(self, q, k, v):
        return self.mech.apply(self.params, self.config, *self._tensors(q, k, v))

    def backward(self, q, k, v, target) -> Gradients:
        """The MSE to `target` and its gradient with respect to the
        parameters."""
        if self.params is None:
            with torch.no_grad():
                return Gradients(grads=None, loss=float(self._loss(None, q, k, v, target)),
                                 grad_norm=0.0)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.params)]
        with torch.enable_grad():
            loss = self._loss(tree_unflatten(self.params, leaves), q, k, v, target)
            grads = torch.autograd.grad(loss, leaves)
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        return Gradients(grads=tree_unflatten(self.params, list(grads)),
                         loss=float(loss.detach()), grad_norm=float(norm))

    def update(self, gradients: Gradients) -> None:
        """One optimizer step."""
        if self.params is None or gradients.grads is None:
            return
        updates, self.opt_state = self.opt.update(gradients.grads, self.opt_state, self.params)
        self.params = apply_updates(self.params, updates)

    def train_step(self, q, k, v, target) -> float:
        g = self.backward(q, k, v, target)
        self.update(g)
        return g.loss
