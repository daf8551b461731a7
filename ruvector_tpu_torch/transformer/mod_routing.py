"""Mixture-of-Depths routing driven by min-cut signals (port of
ruvector_tpu/transformer/mod_routing.py).

Reference: ruvector-mincut-gated-transformer/src/mod_routing.rs — per-token
routing (Compute / Skip / Boundary) with layer capacity targeting a FLOPs
reduction (Raposo et al. 2024), boundary tokens forced to compute, adaptive
capacity from λ stability.

The routing decision is host logic (tiny scalar inputs); the mask is applied
on the device as `where(mask, layer(x), x)`, and the gather/scatter variant
`apply_layer_routed` runs only the compute subset through the layer.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ruvector_tpu_torch.transformer.packets import GatePacket


@dataclasses.dataclass(frozen=True)
class ModRoutingConfig:
    lambda_delta_skip_threshold: int = 3276    # |λ delta| Q15 ~10%
    boundary_token_force_compute: bool = True
    layer_capacity_ratio: float = 0.5          # MoD target: 50% FLOPs cut
    min_tokens_per_layer: int = 4
    adaptive_capacity: bool = True

    @staticmethod
    def with_flops_reduction(r: float) -> "ModRoutingConfig":
        return ModRoutingConfig(layer_capacity_ratio=1.0 - min(max(r, 0.0), 0.9))

    def validate(self):
        if not (0.0 < self.layer_capacity_ratio <= 1.0):
            raise ValueError("layer_capacity_ratio must be in (0, 1]")
        if self.lambda_delta_skip_threshold < 0:
            raise ValueError("lambda_delta_skip_threshold must be non-negative")


class TokenRoute(enum.Enum):
    COMPUTE = 0
    SKIP = 1
    BOUNDARY = 2

    def requires_compute(self) -> bool:
        return self is not TokenRoute.SKIP


@dataclasses.dataclass
class RoutingStats:
    total_tokens: int
    compute_tokens: int
    skip_tokens: int
    boundary_tokens: int

    @property
    def flops_ratio(self) -> float:
        return self.compute_tokens / max(self.total_tokens, 1)


class MincutDepthRouter:
    """mod_routing.rs:124-330 — route tokens by λ stability + boundaries."""

    def __init__(self, config: ModRoutingConfig = ModRoutingConfig()):
        config.validate()
        self.config = config

    def _layer_capacity(self, gate: GatePacket, n: int) -> int:
        ratio = self.config.layer_capacity_ratio
        if self.config.adaptive_capacity:
            # unstable λ -> raise capacity toward 1.0. Relative change in Q15
            # (the threshold's unit per mod_routing.rs:31-33 docs).
            delta_q15 = abs(gate.lambda_delta()) * 32768 // max(gate.lam_prev, 1)
            if delta_q15 > self.config.lambda_delta_skip_threshold:
                ratio = min(1.0, ratio + 0.25)
        return max(int(np.ceil(ratio * n)), min(self.config.min_tokens_per_layer, n))

    def route_tokens(
        self, gate: GatePacket, token_positions: np.ndarray
    ) -> list[TokenRoute]:
        n = len(token_positions)
        if n == 0:
            return []
        routes = [TokenRoute.SKIP] * n
        capacity = self._layer_capacity(gate, n)

        # boundary tokens: evenly spaced partition starts (mod_routing.rs
        # mark_boundary_tokens uses gate partition structure)
        boundary_count = 0
        if self.config.boundary_token_force_compute and gate.partition_count > 1:
            psize = max(n // gate.partition_count, 1)
            for p in range(gate.partition_count):
                pos = p * psize
                if pos < n:
                    routes[pos] = TokenRoute.BOUNDARY
                    boundary_count += 1

        # fill remaining capacity: most-recent tokens first (recency prior)
        remaining = max(capacity - boundary_count, 0)
        for i in range(n - 1, -1, -1):
            if remaining == 0:
                break
            if routes[i] is TokenRoute.SKIP:
                routes[i] = TokenRoute.COMPUTE
                remaining -= 1

        # minimum compute guarantee
        computing = sum(r.requires_compute() for r in routes)
        need = min(self.config.min_tokens_per_layer, n) - computing
        for i in range(n):
            if need <= 0:
                break
            if routes[i] is TokenRoute.SKIP:
                routes[i] = TokenRoute.COMPUTE
                need -= 1
        return routes

    def compute_layer_mask(self, routes: list[TokenRoute], layer: int = 0) -> np.ndarray:
        return np.asarray([r.requires_compute() for r in routes], bool)

    def routing_stats(self, routes: list[TokenRoute]) -> RoutingStats:
        return RoutingStats(
            total_tokens=len(routes),
            compute_tokens=sum(r.requires_compute() for r in routes),
            skip_tokens=sum(r is TokenRoute.SKIP for r in routes),
            boundary_tokens=sum(r is TokenRoute.BOUNDARY for r in routes),
        )


def apply_layer_masked(layer_fn, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked-residual MoD: out = where(mask, layer(x), x)."""
    return torch.where(mask[:, None] > 0, layer_fn(x), x)


def apply_layer_routed(layer_fn, x: torch.Tensor, compute_idx: torch.Tensor) -> torch.Tensor:
    """Gather/scatter MoD for large sequences: only `compute_idx` rows run
    through layer_fn. Others keep the residual."""
    idx = compute_idx.long()
    out = x.clone()
    out[idx] = layer_fn(x[idx])
    return out
