"""SONA core types (sona/src/types.rs; the port's own copy of
ruvector_tpu/sona/types.py)."""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class SonaConfig:
    hidden_dim: int = 256
    embedding_dim: int = 256
    micro_lora_rank: int = 2          # rank 1-2 instant tier
    base_lora_rank: int = 16          # rank 4-16 background tier
    num_layers: int = 2               # layers covered by BaseLoRA
    instant_lr: float = 0.001
    background_lr: float = 0.0005
    flush_threshold: int = 32         # micro updates before apply
    trajectory_capacity: int = 1024
    background_interval_s: float = 60.0
    pattern_clusters: int = 8
    ewc_lambda: float = 100.0
    quality_threshold: float = 0.5    # min quality to learn from


@dataclasses.dataclass
class LearningSignal:
    """Per-query feedback driving the instant loop (types.rs)."""

    gradient_estimate: np.ndarray    # [hidden_dim]
    quality_score: float
    input_embedding: np.ndarray | None = None


@dataclasses.dataclass
class TrajectoryStep:
    activations: np.ndarray
    attention_weights: np.ndarray
    reward: float
    name: str = ""


@dataclasses.dataclass
class QueryTrajectory:
    id: int
    query_embedding: np.ndarray
    steps: list[TrajectoryStep]
    final_quality: float
    model_route: str = ""
    context_ids: list[str] = dataclasses.field(default_factory=list)
    latency_us: int = 0
    timestamp: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class LearnedPattern:
    id: int
    centroid: np.ndarray
    avg_quality: float
    support: int                       # trajectories in the cluster
    access_count: int = 0
    created_at: float = dataclasses.field(default_factory=time.time)
