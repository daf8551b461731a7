"""Differentiable search and the hierarchical GNN forward (port of
ruvector_tpu/serve/search.py; reference ruvector-gnn/src/search.rs).

Similarities are one batched product per layer and the top-k is
`torch.topk`. `torch.topk` returns int64 indices; `differentiable_search`
returns int32, as the JAX package does.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.nn.ruvector_layer import (
    RuvectorLayerConfig,
    ruvector_layer_apply_single,
)
from ruvector_tpu_torch.ops.distance import pairwise_cosine


def softmax_temperature(values: torch.Tensor, temperature: float) -> torch.Tensor:
    """Temperature-scaled softmax with the reference's 1e-10 sum guard
    (search.rs:29-44). The reference scales (x - max)/T, not x/T."""
    m = torch.amax(values, dim=-1, keepdim=True)
    e = torch.exp((values - m) / temperature)
    return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-10)


def differentiable_search(query: torch.Tensor, candidates: torch.Tensor, k: int,
                          temperature: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Soft top-k by cosine similarity (search.rs:56-94): (indices [.., k]
    int32, weights [.., k]). The weights are the temperature softmax over
    all candidates taken at the top-k, so they sum to at most 1."""
    squeeze = query.dim() == 1
    q = query[None, :] if squeeze else query
    soft = softmax_temperature(pairwise_cosine(q, candidates), temperature)
    top_w, top_i = torch.topk(soft, min(k, candidates.shape[0]), dim=-1, sorted=True)
    top_i = top_i.to(torch.int32)
    if squeeze:
        return top_i[0], top_w[0]
    return top_i, top_w


def hierarchical_forward(query: torch.Tensor, layer_embeddings: list[torch.Tensor],
                         gnn_params: list[dict], gnn_cfgs: list[RuvectorLayerConfig],
                         temperature: float = 1.0) -> torch.Tensor:
    """A query down the HNSW hierarchy (search.rs:105-162). Per layer: soft
    top-5 retrieval, the soft-weighted aggregate averaged with the running
    embedding, then a RuvectorLayer forward with the retrieved nodes as
    neighbours and the soft weights as edge weights."""
    current = query
    for embeddings, params, cfg in zip(layer_embeddings, gnn_params, gnn_cfgs):
        n = embeddings.shape[0]
        if n == 0:
            continue
        idx, weights = differentiable_search(current, embeddings, min(5, n), temperature)
        chosen = embeddings[idx.long()]                          # [k, D]
        aggregated = torch.einsum("k,kd->d", weights, chosen)
        combined = (current + aggregated) / 2.0
        current = ruvector_layer_apply_single(params, cfg, combined, chosen, weights)
    return current
