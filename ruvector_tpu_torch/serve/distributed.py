"""Distributed query execution: scatter-gather over a corpus split by rows
(port of ruvector_tpu/serve/distributed.py).

Each rank scores its block of the corpus against the (replicated) query
batch and takes a local top-k; one all-gather brings every rank's
candidates together and a top-k over them merges them.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.ops.distance import pairwise_cosine
from ruvector_tpu_torch.parallel.mesh import Mesh


def make_distributed_search(mesh: Mesh, n_total: int, k: int):
    """search(queries [B, D], features) -> (global ids [B, k] int32, scores
    [B, k]) on this rank, the same on every rank. features are the rank's
    rows [n_total / S, D] (or all [n_total, D], of which the rank takes its
    block). Equal scores follow torch.topk's order (the top-k tie rule)."""
    n_shards = mesh.size
    if n_total % n_shards:
        raise ValueError("pad features to a multiple of the number of ranks")
    block = n_total // n_shards

    def search(queries, features):
        features = mesh.own_rows(features, block)
        local_scores, local_idx = torch.topk(pairwise_cosine(queries, features), k, dim=1,
                                             sorted=True)
        global_idx = local_idx.to(torch.int32) + mesh.rank * block
        b = queries.shape[0]
        # every rank's candidates: [S, B, k] -> [B, S*k], rank-major
        all_scores = mesh.all_gather(local_scores[None]).permute(1, 0, 2).reshape(b, -1)
        all_idx = mesh.all_gather(global_idx[None]).permute(1, 0, 2).reshape(b, -1)
        top_scores, pos = torch.topk(all_scores, k, dim=1, sorted=True)
        return torch.gather(all_idx, 1, pos), top_scores

    return search
