"""Elastic Weight Consolidation over parameter pytrees (port of
ruvector_tpu/training/ewc.py).

Reference: ruvector-gnn/src/ewc.rs: diagonal Fisher from per-sample
gradients (:65-96), anchor consolidation (:103-120), the penalty
lam/2 sum F_i (theta_i - theta*_i)^2 (:130-152) and its gradient
lam F_i (theta_i - theta*_i) (:164-186). The state is a pytree like the
parameters, so one state covers a whole model.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ruvector_tpu_torch.training.optimizers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class EWCState:
    fisher: Any          # pytree like the parameters
    anchor: Any          # pytree like the parameters
    lam: float           # regularisation strength
    active: bool         # the penalty is 0 until consolidated


def ewc_init(params: Any, lam: float) -> EWCState:
    if lam < 0:
        raise ValueError("lambda must be non-negative")
    return EWCState(fisher=tree_map(torch.zeros_like, params),
                    anchor=tree_map(torch.zeros_like, params), lam=float(lam), active=False)


def ewc_compute_fisher(state: EWCState, grads_samples: list) -> EWCState:
    """Fisher_i = (1/N) sum_n g_{n,i}^2 over per-sample gradient pytrees
    (ewc.rs:65-96); replaces the previous Fisher."""
    if not grads_samples:
        return state
    acc = tree_map(torch.zeros_like, grads_samples[0])
    for g in grads_samples:
        acc = tree_map(lambda a, gi: a + gi * gi, acc, g)
    return dataclasses.replace(state, fisher=tree_map(lambda a: a / len(grads_samples), acc))


def ewc_fisher_from_batch(state: EWCState, per_sample_grads: Any) -> EWCState:
    """Fisher from stacked per-sample gradients (a leading batch axis)."""
    return dataclasses.replace(
        state, fisher=tree_map(lambda g: torch.mean(g * g, dim=0), per_sample_grads))


def ewc_consolidate(state: EWCState, params: Any) -> EWCState:
    """Anchor the current parameters and activate the penalty (ewc.rs:103-120)."""
    return dataclasses.replace(state, anchor=tree_map(lambda p: p.detach().clone(), params),
                               active=True)


def ewc_penalty(state: EWCState, params: Any) -> torch.Tensor:
    """lam/2 sum F_i (theta_i - theta*_i)^2, 0 while inactive (ewc.rs:130-152)."""
    terms = tree_leaves(tree_map(lambda f, p, a: torch.sum(f * torch.square(p - a)),
                                 state.fisher, params, state.anchor))
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    if not state.active:
        return torch.zeros_like(total)
    return 0.5 * state.lam * total


def ewc_gradient(state: EWCState, params: Any) -> Any:
    """lam F_i (theta_i - theta*_i) as a pytree; zeros while inactive
    (ewc.rs:164-186)."""
    if not state.active:
        return tree_map(torch.zeros_like, params)
    return tree_map(lambda f, p, a: state.lam * f * (p - a), state.fisher, params, state.anchor)
