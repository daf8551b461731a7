"""Trajectory capture: builder, bounded buffer, id generation.

Reference: sona/src/trajectory.rs — TrajectoryBuilder (:123-222),
TrajectoryBuffer bounded queue with drop counting (:11-120),
TrajectoryIdGen (:226-252). The port's own copy of
ruvector_tpu/sona/trajectory.py (host numpy).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np

from ruvector_tpu_torch.sona.types import QueryTrajectory, TrajectoryStep


class TrajectoryIdGen:
    def __init__(self, start: int = 0):
        self._counter = itertools.count(start)
        self._lock = threading.Lock()
        self._current = start

    def next(self) -> int:
        with self._lock:
            self._current = next(self._counter)
            return self._current

    def current(self) -> int:
        return self._current


class TrajectoryBuilder:
    """Accumulates steps for one query (trajectory.rs:123-222)."""

    def __init__(self, id: int, query_embedding: np.ndarray):
        self.id = id
        self.query_embedding = np.asarray(query_embedding, np.float32)
        self.steps: list[TrajectoryStep] = []
        self.model_route = ""
        self.context_ids: list[str] = []
        self._t0 = time.perf_counter()

    def add_step(self, activations, attention_weights, reward: float,
                 name: str = ""):
        self.steps.append(TrajectoryStep(
            np.asarray(activations, np.float32),
            np.asarray(attention_weights, np.float32),
            float(reward), name,
        ))

    def set_model_route(self, route: str):
        self.model_route = route

    def add_context(self, context_id: str):
        self.context_ids.append(context_id)

    @property
    def step_count(self) -> int:
        return len(self.steps)

    def elapsed_us(self) -> int:
        return int((time.perf_counter() - self._t0) * 1e6)

    def build(self, final_quality: float) -> QueryTrajectory:
        return QueryTrajectory(
            id=self.id,
            query_embedding=self.query_embedding,
            steps=self.steps,
            final_quality=float(final_quality),
            model_route=self.model_route,
            context_ids=self.context_ids,
            latency_us=self.elapsed_us(),
        )


class TrajectoryBuffer:
    """Bounded FIFO with drop accounting (trajectory.rs:11-120)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._q: deque[QueryTrajectory] = deque()
        self._lock = threading.Lock()
        self.dropped = 0
        self.total_seen = 0

    def record(self, t: QueryTrajectory) -> bool:
        with self._lock:
            self.total_seen += 1
            if len(self._q) >= self.capacity:
                self.dropped += 1
                return False
            self._q.append(t)
            return True

    def pop(self) -> QueryTrajectory | None:
        with self._lock:
            return self._q.popleft() if self._q else None

    def drain(self) -> list[QueryTrajectory]:
        with self._lock:
            out = list(self._q)
            self._q.clear()
            return out

    def drain_n(self, n: int) -> list[QueryTrajectory]:
        with self._lock:
            out = [self._q.popleft() for _ in range(min(n, len(self._q)))]
            return out

    def __len__(self) -> int:
        return len(self._q)

    def success_rate(self) -> float:
        if self.total_seen == 0:
            return 1.0
        return 1.0 - self.dropped / self.total_seen
