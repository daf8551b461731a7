"""Training metrics: edges/s, step time, loss curves into the registry
(port of ruvector_tpu/training/metrics_hook.py).

The training loop records device-level throughput (edges/s, step latency)
alongside the serving metrics — one Prometheus-style registry serves both
planes.
"""

from __future__ import annotations

import time

from ruvector_tpu_torch.device import block_until_ready
from ruvector_tpu_torch.utils.metrics import MetricsRegistry


class TrainingMetrics:
    """Wraps a registry with the standard training instruments."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 edges_per_step: int = 0):
        self.registry = registry or MetricsRegistry()
        self.edges_per_step = edges_per_step
        self.steps = self.registry.counter("train_steps_total")
        self.step_time = self.registry.histogram(
            "train_step_seconds", buckets=(0.001, 0.005, 0.01, 0.05, 0.1,
                                           0.5, 1, 5, 30))
        self.loss_sum = self.registry.counter("train_loss_sum")
        self._edges = self.registry.counter("train_edges_total")

    def record_step(self, loss: float, duration_s: float, **labels):
        self.steps.inc(**labels)
        self.step_time.observe(duration_s, **labels)
        self.loss_sum.inc(loss, **labels)
        if self.edges_per_step:
            self._edges.inc(self.edges_per_step, **labels)

    def timed_step(self, step_fn, *args, **labels):
        """Run one step under timing; returns the step's outputs. The clock
        is read after the device has finished the step's last output."""
        t0 = time.perf_counter()
        out = step_fn(*args)
        block_until_ready(out[-1] if isinstance(out, tuple) else out)
        dt = time.perf_counter() - t0
        loss = float(out[2]) if isinstance(out, tuple) and len(out) > 2 else 0.0
        self.record_step(loss, dt, **labels)
        return out

    def edges_per_second(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        total_time = self.step_time._sum.get(key, 0.0)
        edges = self._edges.get(**labels)
        return edges / total_time if total_time > 0 else 0.0
