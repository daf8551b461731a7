"""Sublinear graph attention: LSH buckets and PPR-sampled neighborhoods
(port of ruvector_tpu/graph_transformer/sublinear.py).

Buckets come from signed random projections (one product and the bits'
weights); attention within a bucket is a dense attention under the
bucket-equality mask. PPR sampling takes each query's top-k nodes by the
solver's power-iteration PPR, ranked on a host copy with numpy's argsort
as in the JAX package. The LSH planes are `jax.random.normal` draws
there: the port takes them as an argument, or draws its own from a seeded
CPU generator (the same on every device, not JAX's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.attention.scaled_dot import scaled_dot_attention
from ruvector_tpu_torch.graph.csr import CSRGraph
from ruvector_tpu_torch.ops.segment import masked_softmax
from ruvector_tpu_torch.solver.push import ppr_power_iteration


@dataclasses.dataclass(frozen=True)
class SublinearConfig:
    num_hashes: int = 4          # LSH bits -> 2^bits buckets
    bucket_capacity: int = 64
    ppr_alpha: float = 0.15
    ppr_top_k: int = 32
    seed: int = 0


def lsh_planes(d: int, num_hashes: int, seed: int = 0) -> torch.Tensor:
    """[D, num_hashes] standard-normal planes from a seeded CPU generator."""
    return torch.randn((d, num_hashes), generator=torch.Generator().manual_seed(int(seed)))


def lsh_bucket_assignments(features: torch.Tensor, num_hashes: int, seed: int = 0,
                           planes: torch.Tensor | None = None) -> torch.Tensor:
    """[N, D] -> [N] int32 bucket ids from signed random projections
    (`planes` [D, num_hashes], else lsh_planes(D, num_hashes, seed))."""
    if planes is None:
        planes = lsh_planes(features.shape[-1], num_hashes, seed)
    planes = torch.as_tensor(planes, dtype=torch.float32).to(features.device)
    bits = (features.float() @ planes > 0).to(torch.int32)
    weights = 2 ** torch.arange(num_hashes, dtype=torch.int32, device=features.device)
    return torch.sum(bits * weights, dim=-1, dtype=torch.int32)


def lsh_bucket_attention(features: torch.Tensor, cfg: SublinearConfig = SublinearConfig(),
                         planes: torch.Tensor | None = None) -> torch.Tensor:
    """Self-attention restricted to LSH buckets (sublinear_attention.rs:43+):
    every node attends to the nodes that share its bucket, as a dense
    [N, N] attention under the bucket-equality mask (the JAX package's
    scaled-dot attention over all N keys, one product here)."""
    n, d = features.shape
    buckets = lsh_bucket_assignments(features, cfg.num_hashes, cfg.seed, planes)
    same = (buckets[:, None] == buckets[None, :]).to(features.dtype)
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=features.dtype, device=features.device))
    attn = masked_softmax((features @ features.T) * scale, same, dim=-1)
    return attn @ features


def ppr_sampled_attention(features: torch.Tensor, graph: CSRGraph, query_nodes,
                          cfg: SublinearConfig = SublinearConfig()) -> torch.Tensor:
    """Attention over each query node's top-k PPR-relevant nodes: PPR by
    30 power iterations, top-k on the host, then one batched attention
    over the [Q, K] gathered features."""
    q_idx = np.asarray(query_nodes)
    topk_idx = np.zeros((len(q_idx), cfg.ppr_top_k), np.int64)
    for row, q in enumerate(q_idx):
        ppr = ppr_power_iteration(graph, int(q), cfg.ppr_alpha, iters=30).cpu().numpy()
        topk_idx[row] = np.argsort(-ppr)[: cfg.ppr_top_k]
    gathered = features[torch.from_numpy(topk_idx).to(features.device)]   # [Q, K, D]
    queries = features[torch.from_numpy(q_idx.astype(np.int64)).to(features.device)]
    return scaled_dot_attention(queries, gathered, gathered)
