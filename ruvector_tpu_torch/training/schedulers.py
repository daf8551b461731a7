"""Learning-rate schedules, all six reference variants (port of
ruvector_tpu/training/schedulers.py).

Reference: ruvector-gnn/src/scheduler.rs:10-42: Constant, StepDecay,
Exponential, CosineAnnealing (warm restarts), WarmupLinear, and
ReduceOnPlateau. The first five are step -> lr functions (usable as an
optimizer's learning rate); ReduceOnPlateau is metric-driven host state
(scheduler.rs:105-135).
"""

from __future__ import annotations

import math
from typing import Callable


def constant_schedule(base_lr: float) -> Callable:
    return lambda step: float(base_lr)


def step_decay_schedule(base_lr: float, step_size: int, gamma: float) -> Callable:
    """lr = base * gamma^(floor(step / step_size)) (scheduler.rs:15-17)."""
    return lambda step: base_lr * gamma ** (float(step) // step_size)


def exponential_schedule(base_lr: float, gamma: float) -> Callable:
    """lr = base * gamma^step (scheduler.rs:19-21)."""
    return lambda step: base_lr * gamma ** float(step)


def cosine_annealing_schedule(base_lr: float, t_max: int, eta_min: float = 0.0) -> Callable:
    """lr = eta_min + (base - eta_min) / 2 * (1 + cos(pi (step % t_max) / t_max)):
    warm restarts every t_max steps (scheduler.rs:23-26)."""
    def f(step):
        t = float(step) % t_max
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * t / t_max))
    return f


def warmup_linear_schedule(base_lr: float, warmup_steps: int, total_steps: int) -> Callable:
    """Linear 0 -> base over the warmup, then linear base -> 0
    (scheduler.rs:28-35)."""
    def f(step):
        s = float(step)
        if s < warmup_steps:
            return base_lr * s / max(warmup_steps, 1)
        decay_span = max(total_steps - warmup_steps, 1)
        return base_lr * max(0.0, 1.0 - (s - warmup_steps) / decay_span)
    return f


class ReduceOnPlateau:
    """Metric-driven lr reduction (scheduler.rs:37-41, 105-135):
    step_with_metric(m) resets the patience when m improves by more than
    1e-8, else after `patience` steps without improvement multiplies the lr
    by `factor` (floored at min_lr)."""

    def __init__(self, base_lr: float, factor: float = 0.5, patience: int = 10,
                 min_lr: float = 0.0):
        self.base_lr = base_lr
        self.current_lr = base_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best_metric = math.inf
        self.patience_counter = 0
        self.step_count = 0

    def step_with_metric(self, metric: float) -> float:
        self.step_count += 1
        if metric < self.best_metric - 1e-8:
            self.best_metric = metric
            self.patience_counter = 0
        else:
            self.patience_counter += 1
            if self.patience_counter >= self.patience:
                self.current_lr = max(self.current_lr * self.factor, self.min_lr)
                self.patience_counter = 0
        return self.current_lr


def make_schedule(name: str, base_lr: float, **kw):
    """Factory by name, mirroring the reference's SchedulerType variants."""
    if name == "constant":
        return constant_schedule(base_lr)
    if name == "step_decay":
        return step_decay_schedule(base_lr, kw["step_size"], kw["gamma"])
    if name == "exponential":
        return exponential_schedule(base_lr, kw["gamma"])
    if name == "cosine_annealing":
        return cosine_annealing_schedule(base_lr, kw["t_max"], kw.get("eta_min", 0.0))
    if name == "warmup_linear":
        return warmup_linear_schedule(base_lr, kw["warmup_steps"], kw["total_steps"])
    if name == "reduce_on_plateau":
        return ReduceOnPlateau(base_lr, kw.get("factor", 0.5), kw.get("patience", 10),
                               kw.get("min_lr", 0.0))
    raise ValueError(f"unknown schedule {name!r}")
