"""Optimizers as plain functions over parameter pytrees (port of
ruvector_tpu/training/optimizers.py, which builds on optax).

Reference: ruvector-gnn/src/training.rs: SGD with momentum keeps the
learning rate inside the velocity (v = momentum * v + lr * g; p -= v,
:126-158, unlike torch.optim.SGD and optax.sgd), Adam with bias correction
(:160-227); AdamW as optax.adamw. The update rules follow optax step for
step. An optimizer is a pair of functions: `init(params) -> state` and
`update(grads, state, params) -> (updates, state)`; `apply_updates` adds
the updates. A pytree is a tensor or a dict, list or tuple of pytrees. A
learning rate is a float or a schedule (step -> lr, step counted from 0).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_map(fn, tree, *rest):
    """fn over the tensors of one or more pytrees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of a pytree, in its order (dict keys as stored)."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def sorted_leaves(tree) -> list:
    """The tensors of a pytree in JAX's leaf order (`jax.tree_util.
    tree_leaves`): dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in sorted_leaves(t)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A pytree shaped like `tree` holding `leaves` (tree_leaves order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def requiring_grad(params):
    """params with fresh leaves that require grad."""
    return tree_map(lambda t: t.detach().requires_grad_(True), params)


def tree_grad(loss, req, reduce=None):
    """The gradient of loss for every leaf of the tree req (a leaf that
    loss does not reach gets zeros). With `reduce`, the leaves' gradients
    go through it as one flat vector in JAX's sorted leaf order, so a
    sharded step sums its whole tree in one all-reduce."""
    leaves = sorted_leaves(req)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    if reduce is not None:
        flat = reduce(torch.cat([g.reshape(-1) for g in grads]))
        sizes = [g.numel() for g in grads]
        grads = [f.reshape(g.shape) for f, g in zip(torch.split(flat, sizes), grads)]
    by_leaf = {id(t): g for t, g in zip(leaves, grads)}
    return tree_map(lambda t: by_leaf[id(t)], req)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def apply_updates(params, updates):
    """params + updates, leaf by leaf."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def _lr_at(learning_rate, count: int) -> float:
    return float(learning_rate(count)) if callable(learning_rate) else float(learning_rate)


def sgd(learning_rate, momentum: float = 0.0) -> Optimizer:
    """SGD; with momentum v = momentum * v + lr * g and p -= v
    (training.rs:128-155): the lr sits inside the velocity."""

    def init(params):
        trace = tree_map(torch.zeros_like, params) if momentum else None
        return {"count": 0, "trace": trace}

    def update(grads, state, params=None):
        lr = _lr_at(learning_rate, state["count"])
        if not momentum:
            return (tree_map(lambda g: -lr * g, grads),
                    {"count": state["count"] + 1, "trace": None})
        trace = tree_map(lambda g, t: lr * g + momentum * t, grads, state["trace"])
        return tree_map(torch.neg, trace), {"count": state["count"] + 1, "trace": trace}

    return Optimizer(init, update)


def _adam_direction(grads, state, b1, b2, eps):
    """optax.scale_by_adam: moments, bias correction, mu_hat / (sqrt(nu_hat) + eps)."""
    count = state["count"] + 1
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    direction = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps), mu, nu)
    return direction, {"count": count, "mu": mu, "nu": nu}


def _adam_init(params):
    return {"count": 0, "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam with bias correction (training.rs:169-227; optax.adam)."""

    def update(grads, state, params=None):
        lr = _lr_at(learning_rate, state["count"])
        direction, state = _adam_direction(grads, state, b1, b2, eps)
        return tree_map(lambda u: -lr * u, direction), state

    return Optimizer(_adam_init, update)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    """optax.adamw: the Adam direction plus weight_decay * params, times -lr."""

    def update(grads, state, params):
        lr = _lr_at(learning_rate, state["count"])
        direction, state = _adam_direction(grads, state, b1, b2, eps)
        return tree_map(lambda u, p: -lr * (u + weight_decay * p), direction, params), state

    return Optimizer(_adam_init, update)


def make_optimizer(name: str, learning_rate, **kw) -> Optimizer:
    """Factory by name: 'sgd' | 'adam' | 'adamw'."""
    if name == "sgd":
        return sgd(learning_rate, momentum=kw.get("momentum", 0.0))
    if name == "adam":
        return adam(learning_rate, **{k: v for k, v in kw.items() if k in ("b1", "b2", "eps")})
    if name == "adamw":
        return adamw(learning_rate, **{k: v for k, v in kw.items()
                                       if k in ("b1", "b2", "eps", "weight_decay")})
    raise ValueError(f"unknown optimizer {name!r}")
