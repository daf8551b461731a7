"""Experience replay buffer with reservoir sampling and shift detection
(port of ruvector_tpu/training/replay.py).

Reference: ruvector-gnn/src/replay.rs — reservoir-sampled circular buffer
(:105-166), uniform batch sampling (:168-196), distribution-shift detection
via normalized mean difference against running stats (:199-260).

A host-side component (numpy): the buffer feeds index and feature
batches to the training step and lives beside the store, not in the
compute, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ReplayEntry:
    query: np.ndarray
    positive_ids: list[int]
    timestamp: int = 0


class _RunningStats:
    """Running mean/variance (Welford) per dimension (replay.rs:30-100)."""

    def __init__(self, dim: int):
        self.count = 0
        self.mean = np.zeros(dim, np.float64)
        self.m2 = np.zeros(dim, np.float64)

    def update(self, x: np.ndarray):
        x = np.asarray(x, np.float64)
        if self.mean.shape[0] != x.shape[0]:
            self.mean = np.zeros(x.shape[0], np.float64)
            self.m2 = np.zeros(x.shape[0], np.float64)
            self.count = 0
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self.m2 += delta * (x - self.mean)

    def std(self) -> np.ndarray:
        if self.count < 2:
            return np.zeros_like(self.mean)
        return np.sqrt(self.m2 / self.count)


class ReplayBuffer:
    """Reservoir-sampling replay buffer (replay.rs:105-260)."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self.entries: list[ReplayEntry] = []
        self.total_seen = 0
        self.stats = _RunningStats(0)
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.entries)

    def add(self, query: np.ndarray, positive_ids: list[int]):
        """Reservoir add: always keep when not full; otherwise replace a
        random slot with probability capacity/total_seen (replay.rs:138-166)."""
        entry = ReplayEntry(np.asarray(query, np.float32).copy(), list(positive_ids),
                            timestamp=self.total_seen)
        self.total_seen += 1
        self.stats.update(entry.query)
        if len(self.entries) < self.capacity:
            self.entries.append(entry)
            return
        idx = int(self.rng.integers(0, self.total_seen))
        if idx < self.capacity:
            self.entries[idx] = entry

    def sample(self, batch_size: int) -> list[ReplayEntry]:
        """Uniform sample without replacement (replay.rs:168-196)."""
        if not self.entries:
            return []
        k = min(batch_size, len(self.entries))
        idx = self.rng.choice(len(self.entries), size=k, replace=False)
        return [self.entries[i] for i in idx]

    def sample_arrays(self, batch_size: int) -> tuple[np.ndarray, list[list[int]]]:
        """Sample as (queries [B, D], positive id lists) for the train step."""
        batch = self.sample(batch_size)
        if not batch:
            return np.zeros((0, 0), np.float32), []
        return np.stack([e.query for e in batch]), [e.positive_ids for e in batch]

    def detect_distribution_shift(self, recent_window: int) -> float:
        """Normalized mean-difference shift score (replay.rs:199-260)."""
        if len(self.entries) < recent_window or recent_window == 0:
            return 0.0
        recent = _RunningStats(self.stats.mean.shape[0])
        for e in self.entries[-recent_window:]:
            recent.update(e.query)
        overall_std = self.stats.std()
        valid = overall_std > 1e-8
        if valid.sum() == 0:
            return 0.0
        diff = np.abs(recent.mean[valid] - self.stats.mean[valid]) / overall_std[valid]
        return float(diff.sum() / valid.sum())
