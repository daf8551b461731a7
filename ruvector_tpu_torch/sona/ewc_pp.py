"""EWC++ — online Fisher with task-boundary detection.

Reference: sona/src/ewc.rs — EMA Fisher (:110-125), Welford gradient stats
(:128-145), z-score task-boundary detection (:147-172), task memory with
adaptive lambda (:175-215), gradient constraint scaling 1/(1+λF)
(:216-248), regularization loss (:250-270). The port's own copy of
ruvector_tpu/sona/ewc_pp.py (host numpy).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np


@dataclasses.dataclass(frozen=True)
class EwcConfig:
    param_count: int = 256
    fisher_ema_decay: float = 0.99
    gradient_history_size: int = 100
    boundary_threshold: float = 3.0     # avg z-score triggering a new task
    max_tasks: int = 10
    initial_lambda: float = 100.0
    min_lambda: float = 10.0
    max_lambda: float = 10000.0


@dataclasses.dataclass
class TaskFisher:
    task_id: int
    fisher: np.ndarray
    optimal_weights: np.ndarray
    importance: float = 1.0


class EwcPlusPlus:
    def __init__(self, config: EwcConfig):
        self.config = config
        n = config.param_count
        self.current_fisher = np.zeros(n, np.float32)
        self.current_weights = np.zeros(n, np.float32)
        self.task_memory: deque[TaskFisher] = deque()
        self.current_task_id = 0
        self.lam = config.initial_lambda
        self.gradient_mean = np.zeros(n, np.float32)
        self.gradient_m2 = np.ones(n, np.float32)
        self.samples_seen = 0

    def update_fisher(self, gradients: np.ndarray):
        """F <- decay·F + (1-decay)·g² + Welford stats (ewc.rs:110-145)."""
        g = np.asarray(gradients, np.float32)
        if g.shape[0] != self.config.param_count:
            return
        d = self.config.fisher_ema_decay
        self.current_fisher = d * self.current_fisher + (1 - d) * g * g
        n = self.samples_seen + 1
        delta = g - self.gradient_mean
        self.gradient_mean += delta / n
        self.gradient_m2 += delta * (g - self.gradient_mean)
        self.samples_seen = n

    def detect_task_boundary(self, gradients: np.ndarray) -> bool:
        """Average |z-score| over params > threshold (ewc.rs:147-172)."""
        if self.samples_seen < 50:
            return False
        g = np.asarray(gradients, np.float32)
        if g.shape[0] != self.config.param_count:
            return False
        var = self.gradient_m2 / self.samples_seen
        valid = var > 1e-8
        if not valid.any():
            return False
        z = np.abs(g[valid] - self.gradient_mean[valid]) / np.sqrt(var[valid])
        return float(z.mean()) > self.config.boundary_threshold

    def start_new_task(self):
        """Snapshot Fisher + weights, reset online state (ewc.rs:175-215)."""
        if len(self.task_memory) >= self.config.max_tasks:
            self.task_memory.popleft()
        self.task_memory.append(TaskFisher(
            self.current_task_id,
            self.current_fisher.copy(),
            self.current_weights.copy(),
        ))
        self.current_task_id += 1
        self.current_fisher.fill(0.0)
        self.gradient_mean.fill(0.0)
        self.gradient_m2.fill(1.0)
        self.samples_seen = 0
        # adaptive lambda: more remembered tasks -> more protection
        scale = 1.0 + 0.1 * len(self.task_memory)
        self.lam = float(np.clip(self.config.initial_lambda * scale,
                                 self.config.min_lambda, self.config.max_lambda))

    def set_optimal_weights(self, weights: np.ndarray):
        self.current_weights = np.asarray(weights, np.float32).copy()

    def apply_constraints(self, gradients: np.ndarray) -> np.ndarray:
        """Scale gradients by 1/(1 + λ·F) per remembered task + 0.1·current
        (ewc.rs:216-248)."""
        g = np.asarray(gradients, np.float32).copy()
        if g.shape[0] != self.config.param_count:
            return g
        for task in self.task_memory:
            importance = task.fisher * task.importance
            mask = importance > 1e-8
            g[mask] *= 1.0 / (1.0 + self.lam * importance[mask])
        mask = self.current_fisher > 1e-8
        g[mask] *= 1.0 / (1.0 + self.lam * self.current_fisher[mask] * 0.1)
        return g

    def regularization_loss(self, current_weights: np.ndarray) -> float:
        """Σ_tasks λ/2 Σ_i F_i (w_i - w*_i)² (ewc.rs:250-270)."""
        w = np.asarray(current_weights, np.float32)
        if w.shape[0] != self.config.param_count:
            return 0.0
        loss = 0.0
        for task in self.task_memory:
            loss += float(np.sum(task.fisher * (w - task.optimal_weights) ** 2))
        return 0.5 * self.lam * loss

    def consolidate_all_tasks(self):
        """Merge task Fishers into one maximal importance map (ewc.rs:280+)."""
        if not self.task_memory:
            return
        merged = np.max([t.fisher for t in self.task_memory], axis=0)
        for t in self.task_memory:
            t.fisher = merged.copy()

    def importance_scores(self) -> np.ndarray:
        scores = self.current_fisher.copy()
        for t in self.task_memory:
            scores = np.maximum(scores, t.fisher)
        return scores

    @property
    def task_count(self) -> int:
        return len(self.task_memory)
