"""Min-cut partition-structured sparse attention (port of
ruvector_tpu/transformer/sparse_attention.py).

Reference: ruvector-mincut-gated-transformer/src/sparse_attention.rs —
SparsityConfig (:26-60), LambdaDensitySchedule (Linear/Threshold/Adaptive,
:63-80, :302-335), mask = dense intra-partition blocks + boundary-token
cross attention (:168-280).

The mask is a dense [S, S] bool array built on the host once per gate
state and applied through a masked softmax.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ruvector_tpu_torch.transformer.packets import GatePacket


@dataclasses.dataclass(frozen=True)
class LambdaDensitySchedule:
    kind: str = "adaptive"           # linear | threshold | adaptive
    min_density: float = 0.1
    max_density: float = 0.9
    dense_above_lambda: int = 150


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    intra_partition_attention: bool = True
    boundary_cross_attention: bool = True
    lambda_based_density: Optional[LambdaDensitySchedule] = LambdaDensitySchedule()
    max_cross_partition_edges: int = 20
    min_density_q15: int = 3277
    max_density_q15: int = 29491


@dataclasses.dataclass
class SparseMask:
    mask: np.ndarray            # [S, S] bool (causal already applied)
    density: float
    partition_boundaries: list[int]
    boundary_tokens: list[int]

    @staticmethod
    def full(seq_len: int) -> "SparseMask":
        rows = np.arange(seq_len)[:, None]
        cols = np.arange(seq_len)[None, :]
        return SparseMask((cols <= rows), 1.0, [], [])

    def can_attend(self, q: int, k: int) -> bool:
        return bool(self.mask[q, k])

    def num_positions(self) -> int:
        return int(self.mask.sum())

    def sparsity(self) -> float:
        return 1.0 - self.density


class MincutSparseAttention:
    def __init__(self, config: SparsityConfig = SparsityConfig()):
        self.config = config

    def should_use_sparse(self, gate: GatePacket, seq_len: int) -> bool:
        """sparse_attention.rs:293-300: long enough, partitioned, stable."""
        return seq_len >= 16 and gate.partition_count >= 2 and gate.lam >= 30

    def calculate_density(self, gate: GatePacket) -> float:
        """sparse_attention.rs:302-335 density schedules."""
        sched = self.config.lambda_based_density
        if sched is None:
            return 0.5
        if sched.kind == "linear":
            t = min(max((min(gate.lam, 300) - 30.0) / 270.0, 0.0), 1.0)
            return sched.min_density + t * (sched.max_density - sched.min_density)
        if sched.kind == "threshold":
            return 0.9 if gate.lam >= sched.dense_above_lambda else 0.1
        # adaptive
        base = min(max(gate.lam / 150.0, 0.0), 1.0) * 0.6 + 0.1
        boundary = (gate.boundary_concentration_q15 / 32768.0) * 0.2
        partition = max(-0.05 * gate.partition_count, -0.2)
        return min(max(base + boundary + partition, 0.1), 0.9)

    def estimate_partition_boundaries(self, gate: GatePacket, seq_len: int) -> list[int]:
        p = max(gate.partition_count, 1)
        psize = max(seq_len // p, 1)
        return [i * psize for i in range(p) if i * psize < seq_len]

    def build_mask(self, gate: GatePacket, seq_len: int) -> SparseMask:
        if not self.should_use_sparse(gate, seq_len):
            return SparseMask.full(seq_len)

        density = self.calculate_density(gate)
        boundaries = self.estimate_partition_boundaries(gate, seq_len)
        boundary_tokens = boundaries[: self.config.max_cross_partition_edges]

        # partition id per position
        part = np.zeros(seq_len, np.int32)
        for i, b in enumerate(boundaries):
            part[b:] = i

        rows = np.arange(seq_len)[:, None]
        cols = np.arange(seq_len)[None, :]
        causal = cols <= rows
        mask = np.zeros((seq_len, seq_len), bool)
        if self.config.intra_partition_attention:
            mask |= part[:, None] == part[None, :]
        if self.config.boundary_cross_attention and boundary_tokens:
            bt = np.zeros(seq_len, bool)
            bt[boundary_tokens] = True
            mask |= bt[None, :]        # everyone can attend boundary tokens
            mask |= bt[:, None]        # boundary tokens attend everyone

        # density-driven local widening: ensure a local window scaled by density
        window = max(int(density * seq_len), 1)
        mask |= (rows - cols >= 0) & (rows - cols < window)
        mask &= causal

        full_positions = seq_len * (seq_len + 1) // 2
        return SparseMask(
            mask=mask,
            density=float(mask.sum()) / full_positions,
            partition_boundaries=boundaries,
            boundary_tokens=list(boundary_tokens),
        )

    def estimated_flops_ratio(self, mask: SparseMask, seq_len: int) -> float:
        full = seq_len * (seq_len + 1) / 2
        return mask.num_positions() / max(full, 1)


def sparse_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: np.ndarray | torch.Tensor
) -> torch.Tensor:
    """Masked attention [S, D] given the sparse mask (sparse_attention.rs:223)."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    mask = torch.as_tensor(mask, device=q.device).to(torch.bool)
    scores = torch.matmul(q, k.T) * scale
    # -1e30, not -inf, as JAX: a fully masked row stays finite
    scores = torch.where(mask, scores, -1e30)
    attn = torch.softmax(scores, dim=-1)
    # fully-masked rows -> 0 contribution
    row_any = torch.any(mask, dim=-1, keepdim=True)
    attn = torch.where(row_any, attn, 0.0)
    return torch.matmul(attn, v)
