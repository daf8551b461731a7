"""SONA — self-optimizing two-loop learning engine (port of
ruvector_tpu/sona).

Instant loop (per-query MicroLoRA gradient accumulation, engine.rs:46-77,
loops/instant.rs) + background loop (ReasoningBank k-means pattern
extraction + BaseLoRA consolidation gated by EWC++, loops/background.rs,
reasoning_bank.rs, ewc.rs) coordinated by a LoopCoordinator
(loops/coordinator.rs:13-120). The loops and the adapter state are host
numpy, as in the JAX package; the adapters' forwards run on the card.
"""

from ruvector_tpu_torch.sona.engine import LoopCoordinator, SonaEngine
from ruvector_tpu_torch.sona.ewc_pp import EwcConfig, EwcPlusPlus
from ruvector_tpu_torch.sona.lora import BaseLoRA, MicroLoRA
from ruvector_tpu_torch.sona.reasoning_bank import PatternConfig, ReasoningBank
from ruvector_tpu_torch.sona.trajectory import (
    TrajectoryBuffer,
    TrajectoryBuilder,
    TrajectoryIdGen,
)
from ruvector_tpu_torch.sona.types import (
    LearnedPattern,
    LearningSignal,
    QueryTrajectory,
    SonaConfig,
    TrajectoryStep,
)

__all__ = [
    "SonaConfig", "LearningSignal", "TrajectoryStep", "QueryTrajectory", "LearnedPattern",
    "TrajectoryBuilder", "TrajectoryBuffer", "TrajectoryIdGen", "MicroLoRA", "BaseLoRA",
    "EwcConfig", "EwcPlusPlus", "PatternConfig", "ReasoningBank", "SonaEngine",
    "LoopCoordinator",
]
