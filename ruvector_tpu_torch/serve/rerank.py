"""Candidate re-ranking: attention of each query over its retrieval pool
(port of ruvector_tpu/serve/rerank.py).

The serving pipeline: retrieval pulls an ef-wide candidate pool, and a
re-rank scores the pool against the query. Pools of ef >= 256 on the card
go through the K8 kernel (ops/kernels/flash_neighbor.py), which never
materializes the [B, ef] scores; smaller pools take the blockwise
`flash_attention`. The JAX package keys the kernel on the TPU backend; the
port keys it on a CUDA pool.
"""

from __future__ import annotations

import numpy as np
import torch

from ruvector_tpu_torch.attention.flash import flash_attention
from ruvector_tpu_torch.ops.distance import pairwise_cosine
from ruvector_tpu_torch.ops.kernels.flash_neighbor import flash_neighbor_attention


def rerank_context(queries: torch.Tensor, pool_features: torch.Tensor,
                   use_pallas: bool | None = None) -> torch.Tensor:
    """The attention context [B, D] of each query over its pool [B, ef, D]:
    K8 for ef >= 256 on the card (or when `use_pallas` says so), else the
    blockwise flash attention with blocks of min(128, ef)."""
    ef = pool_features.shape[1]
    if use_pallas is None:
        use_pallas = ef >= 256 and pool_features.is_cuda
    if use_pallas:
        return flash_neighbor_attention(queries, pool_features, pool_features)
    return flash_attention(queries, pool_features, pool_features, block_size=min(128, ef))


def attention_rerank(queries: torch.Tensor, pool_features: torch.Tensor,
                     pool_ids: torch.Tensor, k: int, temperature: float = 1.0,
                     use_pallas: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Rescore candidates by blending raw cosine with the cosine to the
    query's attention context over the pool: candidates aligned with the
    pool's consensus direction under the query rank higher. Returns (ids
    [B, k], scores [B, k])."""
    ctx = rerank_context(queries, pool_features, use_pallas)
    blended = rerank_scores(queries, ctx, pool_features, temperature)
    scores, local = torch.topk(blended, min(k, pool_features.shape[1]), dim=1, sorted=True)
    return torch.gather(pool_ids, 1, local), scores


def rerank_scores(queries: torch.Tensor, ctx: torch.Tensor, pool_features: torch.Tensor,
                  temperature: float = 1.0) -> torch.Tensor:
    """[B, ef] blend of the pool's cosine to the query and to the context."""
    sim_q = pairwise_cosine_rows(queries, pool_features)
    sim_ctx = pairwise_cosine_rows(ctx, pool_features)
    return (0.5 * sim_q + 0.5 * sim_ctx) / temperature


def pairwise_cosine_rows(q: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """[B, D] vs [B, ef, D] -> [B, ef] per-row cosine. Norms are clamped at
    1e-12 (ops.distance.pairwise_cosine maps zero norms to 0 instead)."""
    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    pn = pool / torch.clamp(torch.linalg.vector_norm(pool, dim=-1, keepdim=True), min=1e-12)
    return torch.einsum("bd,bed->be", qn, pn)


def retrieve_candidates(q: torch.Tensor, features: torch.Tensor, ef: int) -> torch.Tensor:
    """Stage 1: the ef nearest corpus rows of each query by cosine, [B, ef]
    int64, from one brute-force product."""
    _, cand = torch.topk(pairwise_cosine(q, features), min(ef, features.shape[0]), dim=1,
                         sorted=True)
    return cand


def retrieve_and_rerank(queries: np.ndarray, features: torch.Tensor, ef: int = 256,
                        k: int = 10, temperature: float = 1.0):
    """Brute-force retrieval of ef candidates, then the attention re-rank:
    (ids [B, k], scores [B, k]) on the corpus's device."""
    with torch.no_grad():
        q = torch.as_tensor(np.asarray(queries, np.float32)).to(features.device)
        cand = retrieve_candidates(q, features, ef)
        return attention_rerank(q, features[cand], cand, k, temperature)
