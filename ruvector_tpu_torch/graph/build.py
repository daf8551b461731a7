"""kNN neighbor-graph construction (port of ruvector_tpu/graph/build.py:22-94).

Brute-force kNN as a blocked `[B, D] x [D, N]` product plus `torch.topk`
on the device, self-matches excluded. The product is a plain matrix
product (XLA's in the JAX package), so it stays `torch.matmul`.
"""

from __future__ import annotations

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.graph.neighbors import NeighborGraph


def _knn_blocked(x: torch.Tensor, k: int, metric: str, block: int):
    """Top-k neighbors of every row of x among all rows of x, self
    excluded. Returns (idx [N, k] int32, sim [N, k] float32)."""
    n = x.shape[0]
    if metric == "cosine":
        xn = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)
    elif metric in ("dot", "euclidean"):
        xn = x
    else:
        raise ValueError(f"unknown metric {metric}")
    xx = torch.sum(xn * xn, dim=1) if metric == "euclidean" else None
    idx_parts, sim_parts = [], []
    for lo in range(0, n, block):
        q = xn[lo:lo + block]
        sims = torch.matmul(q, xn.T)
        if metric == "euclidean":
            # negative squared distance so that top-k = nearest
            sims = -(xx[lo:lo + block, None] + xx[None, :] - 2.0 * sims)
        rows = torch.arange(lo, lo + q.shape[0], device=x.device)
        sims[torch.arange(q.shape[0], device=x.device), rows] = -torch.inf
        top_sim, top_idx = torch.topk(sims, k, dim=1)
        idx_parts.append(top_idx.to(torch.int32))
        sim_parts.append(top_sim)
    return torch.cat(idx_parts), torch.cat(sim_parts)


def build_knn_graph(features, k: int = 16, metric: str = "cosine",
                    weight: str = "similarity", block: int = 1024,
                    device=None) -> NeighborGraph:
    """k-nearest-neighbor NeighborGraph from [N, D] features, on `device`.

    weight: 'similarity' (similarities floored at 1e-6) | 'uniform'.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(features, dtype=torch.float32).to(dev)
    n = x.shape[0]
    k = min(k, n - 1)
    with torch.no_grad():
        idx, sim = _knn_blocked(x, k, metric, min(block, max(8, n)))
    mask = torch.ones((n, k), dtype=torch.float32, device=dev)
    w = torch.clamp(sim, min=1e-6) if weight == "similarity" else mask
    return NeighborGraph(nbr_idx=idx, nbr_mask=mask, edge_weight=w)


def knn_graph_numpy(features: np.ndarray, k: int = 16, metric: str = "cosine"):
    """Pure-numpy reference kNN (for test oracles)."""
    x = np.asarray(features, dtype=np.float64)
    if metric == "cosine":
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    sims = x @ x.T
    np.fill_diagonal(sims, -np.inf)
    idx = np.argsort(-sims, axis=1)[:, :k].astype(np.int32)
    sim = np.take_along_axis(sims, idx, axis=1).astype(np.float32)
    return idx, sim
