"""Batched distance and similarity ops (port of ruvector_tpu/ops/distance.py).

Distances are batched matrix products: one [B, D] x [D, N] product gives
B*N similarities. `cosine_similarity` keeps the reference's zero-norm -> 0
convention (ruvector-gnn/src/search.rs:4-26).
"""

from __future__ import annotations

import torch


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity along the last axis, broadcasting; 0 where either
    norm is 0."""
    dot = torch.sum(a * b, dim=-1)
    denom = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, dot / safe, torch.zeros_like(dot))


def pairwise_dot(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] dot products."""
    return torch.matmul(q, x.T)


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(n > 0, x / torch.where(n > 0, n, torch.ones_like(n)), torch.zeros_like(x))


def pairwise_cosine(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] cosine similarities; zero-norm rows -> 0."""
    return torch.matmul(_unit_rows(q), _unit_rows(x).T)


def pairwise_euclidean(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] squared Euclidean distances via a product."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    xx = torch.sum(x * x, dim=-1)[None, :]
    return torch.clamp(qq + xx - 2.0 * torch.matmul(q, x.T), min=0.0)
