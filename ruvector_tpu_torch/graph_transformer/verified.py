"""Verified training: delta-apply steps with invariant checks and sealed
certificates (port of ruvector_tpu/graph_transformer/verified.py).

Invariants (verified_training.rs:85-151): loss stability, weight norm,
Lipschitz bound, permutation equivariance, energy gate. VerifiedTrainer
(:343-580) computes the candidate update (autograd and an optimizer of
`training/optimizers`), checks every invariant on the proposed state and
commits only when all pass; seal (:580-612) chains sha256 hashes of the
step records and hashes the final weights' bytes. The weights are
flattened in the JAX package's leaf order (dict keys sorted, lists in
order) and the records are the same JSON, so a certificate of the same
steps has the same hashes in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable

import numpy as np
import torch

from ruvector_tpu_torch.training.optimizers import (
    Optimizer,
    apply_updates,
    sorted_leaves,
    tree_leaves,
    tree_unflatten,
)


# --- invariants ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LossStabilityBound:
    """Loss within spike_cap of its EMA; gradient and step norms bounded
    (verified_training.rs:93-101)."""

    spike_cap: float = 0.5
    max_gradient_norm: float = 100.0
    max_step_size: float = 10.0
    name: str = "loss_stability_bound"


@dataclasses.dataclass(frozen=True)
class WeightNormBound:
    max_norm: float = 1000.0
    name: str = "weight_norm_bound"


@dataclasses.dataclass(frozen=True)
class LipschitzBound:
    tolerance: float = 100.0
    max_power_iterations: int = 8
    name: str = "lipschitz_bound"


@dataclasses.dataclass(frozen=True)
class PermutationEquivariance:
    rng_seed: int = 42
    tolerance: float = 1e-3
    name: str = "permutation_equivariance"


@dataclasses.dataclass(frozen=True)
class EnergyGateInvariant:
    energy_threshold: float = 1e-8
    name: str = "energy_gate"


TrainingInvariant = (
    LossStabilityBound | WeightNormBound | LipschitzBound
    | PermutationEquivariance | EnergyGateInvariant
)


@dataclasses.dataclass
class InvariantCheckResult:
    name: str
    passed: bool
    value: float
    threshold: float


@dataclasses.dataclass
class TrainingStepResult:
    step: int
    loss: float
    committed: bool
    checks: list[InvariantCheckResult]

    def record_hash(self, prev_hash: str) -> str:
        payload = json.dumps({
            "step": self.step, "loss": round(self.loss, 8),
            "committed": self.committed,
            "checks": [(c.name, c.passed, round(c.value, 8)) for c in self.checks],
            "prev": prev_hash,
        }, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()


@dataclasses.dataclass
class TrainingCertificate:
    steps: int
    committed_steps: int
    total_violations: int
    final_weights_hash: str
    chain_hash: str
    invariants: list[str]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tree_leaves(tree)))


# --- trainer ------------------------------------------------------------------

class VerifiedTrainer:
    """Wraps a (loss_fn, optimizer) pair with fail-closed verified steps.

    loss_fn(params, batch) -> scalar loss tensor. Each step computes the
    candidate update, checks every invariant on the PROPOSED state, and
    commits only when all pass (delta-apply, verified_training.rs:409+).
    """

    def __init__(self, loss_fn: Callable, optimizer: Optimizer, params: Any,
                 invariants: list[TrainingInvariant], forward_fn: Callable | None = None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.params = params
        self.opt_state = optimizer.init(params)
        self.invariants = invariants
        self.forward_fn = forward_fn
        self.step_count = 0
        self.loss_ema: float | None = None
        self.loss_ema_alpha = 0.1
        self.step_results: list[TrainingStepResult] = []
        self.total_violations = 0

    def _candidate_step(self, batch):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(self.params)]
        with torch.enable_grad():
            loss = self.loss_fn(tree_unflatten(self.params, leaves), batch)
            grads = tree_unflatten(self.params, torch.autograd.grad(loss, leaves))
        with torch.no_grad():
            updates, new_opt_state = self.optimizer.update(grads, self.opt_state, self.params)
            new_params = apply_updates(self.params, updates)
            norms = torch.stack([global_norm(grads), global_norm(updates),
                                 global_norm(new_params)]).tolist()
        return float(loss.detach()), new_params, new_opt_state, *norms

    # -- invariant evaluation -------------------------------------------------

    def _check(self, inv, loss, gnorm, unorm, wnorm, new_params, batch) -> InvariantCheckResult:
        if isinstance(inv, LossStabilityBound):
            ema = self.loss_ema if self.loss_ema is not None else loss
            spike = (loss - ema) / max(abs(ema), 1e-12)
            ok = (spike <= inv.spike_cap and gnorm <= inv.max_gradient_norm
                  and unorm <= inv.max_step_size)
            return InvariantCheckResult(inv.name, ok, float(spike), inv.spike_cap)
        if isinstance(inv, WeightNormBound):
            return InvariantCheckResult(inv.name, wnorm <= inv.max_norm, float(wnorm),
                                        inv.max_norm)
        if isinstance(inv, LipschitzBound):
            lip = self._estimate_lipschitz(new_params, inv.max_power_iterations)
            return InvariantCheckResult(inv.name, lip <= inv.tolerance, float(lip),
                                        inv.tolerance)
        if isinstance(inv, PermutationEquivariance):
            dev = self._equivariance_deviation(new_params, batch, inv.rng_seed)
            return InvariantCheckResult(inv.name, dev <= inv.tolerance, float(dev),
                                        inv.tolerance)
        if isinstance(inv, EnergyGateInvariant):
            energy = float(gnorm) ** 2
            return InvariantCheckResult(inv.name, energy >= inv.energy_threshold, energy,
                                        inv.energy_threshold)
        raise TypeError(f"unknown invariant {inv}")

    def _estimate_lipschitz(self, params, iters: int) -> float:
        """Product of per-matrix spectral norms (power iteration, host)."""
        total = 1.0
        for leaf in sorted_leaves(params):
            a = leaf.detach().cpu().numpy()
            if a.ndim != 2:
                continue
            v = np.ones(a.shape[1]) / np.sqrt(a.shape[1])
            for _ in range(iters):
                w = a.T @ (a @ v)
                n = np.linalg.norm(w)
                if n < 1e-12:
                    break
                v = w / n
            total *= float(np.linalg.norm(a @ v))
        return total

    def _equivariance_deviation(self, params, batch, seed: int) -> float:
        """||P^-1 f(P x) - f(x)|| / ||f(x)|| with a seeded permutation, for a
        forward_fn(params, features) that acts row-wise over nodes; 0.0
        without a forward_fn."""
        if self.forward_fn is None:
            return 0.0
        feats = batch["features"] if isinstance(batch, dict) else batch
        x = torch.as_tensor(feats)
        perm = np.random.default_rng(seed).permutation(x.shape[0])
        perm_t = torch.from_numpy(perm).to(x.device)
        with torch.no_grad():
            out = self.forward_fn(params, x).detach().cpu().numpy()
            out_p = self.forward_fn(params, x[perm_t]).detach().cpu().numpy()
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        dev = np.linalg.norm(out_p[inv] - out)
        return float(dev / max(np.linalg.norm(out), 1e-12))

    # -- step -----------------------------------------------------------------

    def train_step(self, batch) -> TrainingStepResult:
        loss, new_params, new_opt_state, gnorm, unorm, wnorm = self._candidate_step(batch)
        checks = [self._check(inv, loss, gnorm, unorm, wnorm, new_params, batch)
                  for inv in self.invariants]
        committed = bool(all(c.passed for c in checks) and np.isfinite(loss))
        if committed:
            self.params = new_params
            self.opt_state = new_opt_state
            self.loss_ema = (loss if self.loss_ema is None
                             else (1 - self.loss_ema_alpha) * self.loss_ema
                             + self.loss_ema_alpha * loss)
        else:
            self.total_violations += sum(not c.passed for c in checks)
        self.step_count += 1
        result = TrainingStepResult(self.step_count, loss, committed, checks)
        self.step_results.append(result)
        return result

    def seal(self) -> TrainingCertificate:
        """The certificate: a sha256 chain over the step records and the
        hash of the final weights' bytes in JAX's leaf order
        (verified_training.rs:580-612)."""
        chain = "genesis"
        for r in self.step_results:
            chain = r.record_hash(chain)
        flat = np.concatenate([leaf.detach().cpu().numpy().reshape(-1)
                               for leaf in sorted_leaves(self.params)])
        return TrainingCertificate(
            steps=self.step_count,
            committed_steps=sum(r.committed for r in self.step_results),
            total_violations=self.total_violations,
            final_weights_hash=hashlib.sha256(flat.tobytes()).hexdigest(),
            chain_hash=chain,
            invariants=[inv.name for inv in self.invariants])

    @property
    def latest_loss(self) -> float | None:
        return self.step_results[-1].loss if self.step_results else None
