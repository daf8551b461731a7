"""Federated LoRA training: aggregate adapters across participants.

Reference: sona/src/training/federated.rs — multiple SONA instances learn
locally; a coordinator aggregates their adapter deltas (FedAvg weighted by
trajectory counts / quality) and broadcasts the merged state.

This runs across training jobs (not devices): each site exports its LoRA
state (export.py), the coordinator averages, and sites import the merged
adapters. Host numpy (port of ruvector_tpu/sona/federated.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ruvector_tpu_torch.sona.lora import BaseLoRA, MicroLoRA


@dataclasses.dataclass
class FederatedUpdate:
    """One participant's contribution."""

    micro_up: np.ndarray
    base_ups: list[np.ndarray]
    weight: float = 1.0       # e.g. trajectory count or mean quality


class FederatedAggregator:
    """FedAvg over LoRA `up` matrices (the adaptation state; `down` is the
    frozen deterministic init shared by construction)."""

    def __init__(self, hidden_dim: int, micro_rank: int = 2,
                 num_layers: int = 2, base_rank: int = 16, device=None):
        self.reference_micro = MicroLoRA(hidden_dim, micro_rank, device=device)
        self.reference_base = BaseLoRA(hidden_dim, num_layers, base_rank, device=device)

    @staticmethod
    def collect(engine, weight: float | None = None) -> FederatedUpdate:
        micro = engine.coordinator.instant.micro_lora
        base = engine.coordinator.background.base_lora
        w = weight if weight is not None else max(
            float(engine.stats.trajectories_seen), 1.0
        )
        return FederatedUpdate(
            micro_up=micro.up.copy(),
            base_ups=[u.copy() for u in base.up],
            weight=w,
        )

    def aggregate(self, updates: list[FederatedUpdate]) -> FederatedUpdate:
        """Weighted average of adapter states."""
        if not updates:
            raise ValueError("no updates to aggregate")
        total = sum(u.weight for u in updates)
        micro = sum(u.micro_up * (u.weight / total) for u in updates)
        n_layers = len(updates[0].base_ups)
        base = [
            sum(u.base_ups[l] * (u.weight / total) for u in updates)
            for l in range(n_layers)
        ]
        return FederatedUpdate(micro_up=micro, base_ups=base, weight=total)

    @staticmethod
    def apply(engine, merged: FederatedUpdate):
        engine.coordinator.instant.micro_lora.up = merged.micro_up.copy()
        base = engine.coordinator.background.base_lora
        for l in range(base.num_layers):
            base.up[l] = merged.base_ups[l].copy()
