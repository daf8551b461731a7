"""Hard-negative mining + curriculum scheduling + regularizers (port of
ruvector_tpu/training/mining.py).

Reference: ruvector-attention/src/training/{mining,curriculum}.rs —
HardNegativeMiner (strategies: hard / semi-hard with margin / distance-
weighted), InBatchMiner, CurriculumStage/CurriculumScheduler (difficulty,
duration, temperature, negative count per stage), temperature annealing,
spectral regularization.

The similarities and the top-k run on the inputs' device. Equal scores may
come back in another order than `lax.top_k`'s (lower index first), so an
id may differ from the JAX package's only as a swap among equal scores or
at a tie with the k-th score. Distance-weighted sampling draws on the host
from the caller's numpy Generator, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.ops.distance import pairwise_cosine
from ruvector_tpu_torch.training.optimizers import sorted_leaves


# --- hard negative mining ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MiningConfig:
    strategy: str = "hard"       # hard | semi_hard | distance_weighted
    margin: float = 0.2
    temperature: float = 0.07
    n_negatives: int = 16


def mine_negatives(
    anchors: torch.Tensor,       # [B, D]
    candidates: torch.Tensor,    # [N, D] negative pool
    positives: torch.Tensor,     # [B, D] each anchor's positive
    cfg: MiningConfig = MiningConfig(),
    rng: np.random.Generator | None = None,
) -> torch.Tensor:
    """Select negative indices [B, K] (int32, on the anchors' device) from
    the pool per strategy.

    hard: highest-similarity negatives (most confusable).
    semi_hard: negatives harder than (pos_sim - margin) but easier than the
      positive — the stable triplet-mining band.
    distance_weighted: sample ∝ softmax(sim/temperature) (needs rng).
    """
    sims = pairwise_cosine(anchors, candidates)                 # [B, N]
    pos_sims = torch.sum(anchors * positives, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(anchors, dim=-1) * torch.linalg.vector_norm(positives, dim=-1),
        min=1e-12)

    k = min(cfg.n_negatives, candidates.shape[0])
    if cfg.strategy == "hard":
        return torch.topk(sims, k).indices.to(torch.int32)
    if cfg.strategy == "semi_hard":
        in_band = (sims > (pos_sims[:, None] - cfg.margin)) & (sims < pos_sims[:, None])
        scored = torch.where(in_band, sims, torch.full_like(sims, -torch.inf))
        # fall back to hard negatives when the band is empty
        scored = torch.where(torch.any(in_band, dim=1, keepdim=True), scored, sims)
        return torch.topk(scored, k).indices.to(torch.int32)
    if cfg.strategy == "distance_weighted":
        rng = rng or np.random.default_rng(0)
        p = torch.softmax(sims / cfg.temperature, dim=-1).cpu().numpy()
        out = np.stack([
            rng.choice(candidates.shape[0], size=k, replace=False, p=row / row.sum())
            for row in p
        ])
        return torch.from_numpy(out.astype(np.int32)).to(anchors.device)
    raise ValueError(f"unknown strategy {cfg.strategy}")


def in_batch_negatives(batch_size: int, include_positive: bool = False,
                       device=None) -> torch.Tensor:
    """InBatchMiner (mining.rs:237-280): each row's negatives are the other
    rows of the batch. Returns the [B, B-1] (or [B, B]) int32 index matrix
    on `device` (default: the card)."""
    dev = resolve_device(device)
    idx = torch.arange(batch_size, device=dev)
    grid = idx[None, :].expand(batch_size, batch_size)
    if include_positive:
        return grid.to(torch.int32).contiguous()
    mask = grid != idx[:, None]
    return grid[mask].reshape(batch_size, batch_size - 1).to(torch.int32)


# --- curriculum -------------------------------------------------------------

@dataclasses.dataclass
class CurriculumStage:
    name: str
    difficulty: float = 0.5
    duration: int = 1000
    temperature: float = 0.07
    negative_count: int = 16


class CurriculumScheduler:
    """Stage progression by step count (curriculum.rs:58-130)."""

    def __init__(self, stages: Iterable[CurriculumStage] = ()):
        self.stages = list(stages)
        self.step_count = 0

    def add_stage(self, stage: CurriculumStage) -> "CurriculumScheduler":
        self.stages.append(stage)
        return self

    @staticmethod
    def default_curriculum(total_steps: int) -> "CurriculumScheduler":
        """easy -> medium -> hard thirds (curriculum.rs:82-115)."""
        third = max(total_steps // 3, 1)
        return CurriculumScheduler([
            CurriculumStage("easy", 0.2, third, temperature=0.1,
                            negative_count=8),
            CurriculumStage("medium", 0.5, third, temperature=0.07,
                            negative_count=16),
            CurriculumStage("hard", 0.9, total_steps - 2 * third,
                            temperature=0.05, negative_count=32),
        ])

    def current_stage(self) -> CurriculumStage | None:
        acc = 0
        for s in self.stages:
            acc += s.duration
            if self.step_count < acc:
                return s
        return self.stages[-1] if self.stages else None

    def step(self) -> CurriculumStage | None:
        self.step_count += 1
        return self.current_stage()


def anneal_temperature(step: int, total_steps: int, t_start: float = 0.1,
                       t_end: float = 0.05) -> float:
    """Linear temperature annealing over training."""
    frac = min(step / max(total_steps, 1), 1.0)
    return t_start + frac * (t_end - t_start)


# --- spectral regularization ------------------------------------------------

def spectral_regularizer(params, power_iters: int = 4) -> torch.Tensor:
    """Σ over weight matrices of (largest singular value)² — penalizes
    spectral growth (training/loss.rs spectral regularization).

    The matrices are the 2-D leaves in JAX's leaf order (dict keys
    sorted), so the float32 sum adds them in the JAX package's order.
    Differentiable: the power iteration is plain autograd."""
    mats = [leaf for leaf in sorted_leaves(params) if leaf.ndim == 2]
    total = torch.zeros((), device=mats[0].device if mats else None)
    for leaf in mats:
        v = torch.ones(leaf.shape[1], device=leaf.device) / float(np.sqrt(leaf.shape[1]))
        for _ in range(power_iters):
            w = leaf.T @ (leaf @ v)
            v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-12)
        total = total + torch.sum((leaf @ v) ** 2)
    return total
