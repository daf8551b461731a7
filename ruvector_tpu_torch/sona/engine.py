"""SonaEngine + LoopCoordinator — the two-loop learning architecture.

Reference: sona/src/engine.rs (:8-235), loops/coordinator.rs (:13-120),
loops/instant.rs (instant loop, <1ms budget), loops/background.rs
(pattern extraction + BaseLoRA consolidation + EWC++ bookkeeping).
Port of ruvector_tpu/sona/engine.py: the loops run on the host in numpy,
as there; the adapters' forwards (`apply_micro_lora`, `apply_base_lora`)
return tensors on the engine's device, the CUDA card unless the caller
asks for another.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ruvector_tpu_torch.sona.ewc_pp import EwcConfig, EwcPlusPlus
from ruvector_tpu_torch.sona.lora import BaseLoRA, MicroLoRA
from ruvector_tpu_torch.sona.reasoning_bank import PatternConfig, ReasoningBank
from ruvector_tpu_torch.sona.trajectory import (
    TrajectoryBuffer,
    TrajectoryBuilder,
    TrajectoryIdGen,
)
from ruvector_tpu_torch.sona.types import LearningSignal, QueryTrajectory, SonaConfig


@dataclasses.dataclass
class BackgroundResult:
    trajectories_processed: int
    patterns_extracted: int
    elapsed_s: float
    status: str = "ok"


@dataclasses.dataclass
class CoordinatorStats:
    trajectories_seen: int = 0
    instant_updates: int = 0
    background_cycles: int = 0
    patterns_total: int = 0
    task_boundaries: int = 0


class InstantLoop:
    """Loop A: per-query MicroLoRA accumulation (loops/instant.rs:103)."""

    def __init__(self, cfg: SonaConfig, device=None):
        self.cfg = cfg
        self.micro_lora = MicroLoRA(cfg.hidden_dim, cfg.micro_lora_rank, device=device)
        self.pending = 0

    def on_trajectory(self, t: QueryTrajectory):
        if t.final_quality < self.cfg.quality_threshold or not t.steps:
            return
        # gradient estimate = quality-weighted mean step activation direction
        acc = np.zeros(self.cfg.hidden_dim, np.float32)
        for step in t.steps:
            a = np.asarray(step.activations, np.float32)
            acc[: min(len(a), len(acc))] += a[: len(acc)] * step.reward
        norm = np.linalg.norm(acc)
        if norm < 1e-8:
            return
        self.micro_lora.accumulate_gradient(
            LearningSignal(acc / norm, t.final_quality)
        )
        self.pending += 1
        if self.pending >= self.cfg.flush_threshold:
            self.flush()

    def flush(self):
        self.micro_lora.apply_accumulated(self.cfg.instant_lr)
        self.pending = 0


class BackgroundLoop:
    """Loop B: pattern extraction + BaseLoRA + EWC++ (loops/background.rs).

    Per-PARAMETER consolidation: the EWC++ Fisher/constraint state spans
    every BaseLoRA up-projection parameter (num_layers x rank x hidden
    flattened), not an activation-proxy vector. The cycle follows
    background.rs:108-168 exactly: pattern gradients -> apply EWC
    constraints -> detect task boundary on the RAW gradient -> update
    Fisher with the CONSTRAINED gradient -> apply to BaseLoRA.
    """

    def __init__(self, cfg: SonaConfig, device=None):
        self.cfg = cfg
        self.bank = ReasoningBank(PatternConfig(
            k_clusters=cfg.pattern_clusters,
            embedding_dim=cfg.embedding_dim,
        ))
        self.base_lora = BaseLoRA(cfg.hidden_dim, cfg.num_layers,
                                  cfg.base_lora_rank, device=device)
        self._up_param_count = (cfg.num_layers * cfg.base_lora_rank
                                * cfg.hidden_dim)
        self.ewc = EwcPlusPlus(EwcConfig(
            param_count=self._up_param_count, initial_lambda=cfg.ewc_lambda,
        ))
        self.task_boundaries = 0

    def _pattern_gradient(self, patterns) -> np.ndarray | None:
        """Lift pattern centroids to the BaseLoRA up-parameter space.

        The weighted centroid direction (weight = avg_quality x
        cluster_size, background.rs:174-196) becomes, per layer, the
        rank-1 up-projection gradient outer(down_l^T d, d) — the full
        [rank, hidden] gradient of `up_l` for moving layer outputs
        toward the pattern direction (vs the reference's elementwise
        slice-splitting of a dim-vector, background.rs:198-218; same
        signal, proper parameter geometry)."""
        acc = np.zeros(self.cfg.hidden_dim, np.float32)
        total = 0.0
        for p in patterns:
            wgt = p.avg_quality * max(getattr(p, "cluster_size", 1), 1)
            acc += p.centroid[: self.cfg.hidden_dim] * wgt
            total += wgt
        if total <= 0:
            return None
        d = acc / total
        norm = np.linalg.norm(d)
        if norm < 1e-8:
            return None
        d = d / norm
        grads = []
        for layer in range(self.cfg.num_layers):
            proj = self.base_lora.down[layer].T @ d          # [rank]
            grads.append(np.outer(proj, d).reshape(-1))      # rank*hidden
        return np.concatenate(grads)

    def run_cycle(self, trajectories: list[QueryTrajectory]) -> BackgroundResult:
        t0 = time.perf_counter()
        for t in trajectories:
            self.bank.add_trajectory(t)

        patterns = self.bank.extract_patterns()
        grad = self._pattern_gradient(patterns) if patterns else None
        if grad is not None:
            constrained = self.ewc.apply_constraints(grad)
            if self.ewc.detect_task_boundary(grad):
                self.ewc.start_new_task()
                self.task_boundaries += 1
            self.ewc.update_fisher(constrained)
            per_layer = self.cfg.base_lora_rank * self.cfg.hidden_dim
            for layer in range(self.cfg.num_layers):
                sl = constrained[layer * per_layer: (layer + 1) * per_layer]
                self.base_lora.apply_gradients(
                    layer,
                    sl.reshape(self.cfg.base_lora_rank, self.cfg.hidden_dim),
                    self.cfg.background_lr,
                )
            self.ewc.set_optimal_weights(np.concatenate(
                [u.reshape(-1) for u in self.base_lora.up]))
        return BackgroundResult(
            trajectories_processed=len(trajectories),
            patterns_extracted=len(patterns),
            elapsed_s=time.perf_counter() - t0,
        )


class LoopCoordinator:
    """Routes trajectories to the loops (loops/coordinator.rs:13-120)."""

    def __init__(self, cfg: SonaConfig, device=None):
        self.cfg = cfg
        self.instant = InstantLoop(cfg, device)
        self.background = BackgroundLoop(cfg, device)
        self.buffer = TrajectoryBuffer(cfg.trajectory_capacity)
        self.idgen = TrajectoryIdGen()
        self.stats = CoordinatorStats()
        self._last_background = time.monotonic()

    def next_trajectory_id(self) -> int:
        return self.idgen.next()

    def on_inference(self, t: QueryTrajectory):
        self.stats.trajectories_seen += 1
        self.instant.on_trajectory(t)
        self.stats.instant_updates += 1
        self.buffer.record(t)

    def maybe_run_background(self) -> BackgroundResult | None:
        now = time.monotonic()
        if now - self._last_background < self.cfg.background_interval_s:
            return None
        if len(self.buffer) == 0:
            return None
        return self.force_background()

    def force_background(self) -> BackgroundResult:
        self._last_background = time.monotonic()
        trajectories = self.buffer.drain()
        result = self.background.run_cycle(trajectories)
        self.stats.background_cycles += 1
        self.stats.patterns_total = self.background.bank.pattern_count
        self.stats.task_boundaries = self.background.task_boundaries
        return result

    def flush_instant(self):
        self.instant.flush()


class SonaEngine:
    """Facade (engine.rs:8-235)."""

    def __init__(self, hidden_dim: int = 256,
                 config: SonaConfig | None = None, device=None):
        self.config = config or SonaConfig(hidden_dim=hidden_dim,
                                           embedding_dim=hidden_dim)
        self.coordinator = LoopCoordinator(self.config, device)
        self.enabled = True

    def begin_trajectory(self, query_embedding) -> TrajectoryBuilder:
        return TrajectoryBuilder(
            self.coordinator.next_trajectory_id(), query_embedding
        )

    def end_trajectory(self, builder: TrajectoryBuilder, quality: float):
        if self.enabled:
            self.coordinator.on_inference(builder.build(quality))

    def submit_trajectory(self, t: QueryTrajectory):
        if self.enabled:
            self.coordinator.on_inference(t)

    def apply_micro_lora(self, x):
        """y = x + adapter(x) on the engine's device (rank 1-2)."""
        if not self.enabled:
            return x
        return self.coordinator.instant.micro_lora.forward(x)

    def apply_base_lora(self, layer_idx: int, x):
        if not self.enabled:
            return x
        return self.coordinator.background.base_lora.forward_layer(layer_idx, x)

    def tick(self) -> str | None:
        if not self.enabled:
            return None
        r = self.coordinator.maybe_run_background()
        if r is None:
            return None
        return (f"Background cycle: {r.trajectories_processed} trajectories"
                f" -> {r.patterns_extracted} patterns in {r.elapsed_s:.3f}s")

    def force_learn(self) -> str:
        r = self.coordinator.force_background()
        return (f"Forced learning: {r.trajectories_processed} trajectories"
                f" -> {r.patterns_extracted} patterns, status: {r.status}")

    def flush(self):
        self.coordinator.flush_instant()

    def find_similar_patterns(self, query, k: int = 3):
        return self.coordinator.background.bank.find_similar(query, k)

    @property
    def stats(self) -> CoordinatorStats:
        return self.coordinator.stats
