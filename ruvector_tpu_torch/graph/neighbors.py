"""Padded fixed-degree neighbor graph (port of ruvector_tpu/graph/neighbors.py).

Adjacency is a dense `[N, M]` int32 index tensor plus a validity mask and
per-edge weights; variable degree pads with index 0 and mask 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class NeighborGraph:
    """nbr_idx [N, M] int32 (padded with 0), nbr_mask [N, M] float32
    (1 = real edge), edge_weight [N, M] float32 (ignored where masked)."""

    nbr_idx: torch.Tensor
    nbr_mask: torch.Tensor
    edge_weight: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.nbr_idx.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr_idx.shape[1]

    def degrees(self) -> torch.Tensor:
        """[N] float32 — true (unpadded) degree of each node."""
        return torch.sum(self.nbr_mask, dim=1)

    @staticmethod
    def from_lists(neighbor_lists: list[list[int]],
                   weights: list[list[float]] | None = None,
                   max_degree: int | None = None,
                   device=None) -> "NeighborGraph":
        """Build from ragged Python neighbor lists on `device`."""
        dev = resolve_device(device)
        n = len(neighbor_lists)
        m = max_degree or max((len(l) for l in neighbor_lists), default=1)
        m = max(m, 1)
        idx = np.zeros((n, m), dtype=np.int32)
        mask = np.zeros((n, m), dtype=np.float32)
        w = np.zeros((n, m), dtype=np.float32)
        for i, nbrs in enumerate(neighbor_lists):
            k = min(len(nbrs), m)
            idx[i, :k] = nbrs[:k]
            mask[i, :k] = 1.0
            w[i, :k] = weights[i][:k] if weights is not None else 1.0
        return NeighborGraph(torch.from_numpy(idx).to(dev),
                             torch.from_numpy(mask).to(dev),
                             torch.from_numpy(w).to(dev))

    def gather(self, features: torch.Tensor) -> torch.Tensor:
        """[N, D] -> [N, M, D] neighbor features."""
        return features[self.nbr_idx.long()]

    def to_csr(self):
        """Convert to CSR on the graph's device."""
        from ruvector_tpu_torch.graph.csr import CSRGraph

        mask = self.nbr_mask > 0
        deg = mask.sum(dim=1).to(torch.int32)
        row_ptr = torch.zeros(self.num_nodes + 1, dtype=torch.int32,
                              device=self.nbr_idx.device)
        row_ptr[1:] = torch.cumsum(deg, 0)
        return CSRGraph(row_ptr=row_ptr,
                        col_idx=self.nbr_idx[mask].to(torch.int32),
                        values=self.edge_weight[mask].to(torch.float32),
                        num_nodes=self.num_nodes)


def pad_degree_to(graph: NeighborGraph, m: int) -> NeighborGraph:
    """Pad (or truncate) max_degree to `m`."""
    cur = graph.nbr_idx.shape[1]
    if cur == m:
        return graph
    if cur > m:
        return NeighborGraph(graph.nbr_idx[:, :m], graph.nbr_mask[:, :m],
                             graph.edge_weight[:, :m])
    pad = (0, m - cur)
    return NeighborGraph(torch.nn.functional.pad(graph.nbr_idx, pad),
                         torch.nn.functional.pad(graph.nbr_mask, pad),
                         torch.nn.functional.pad(graph.edge_weight, pad))
