"""CSR graph representation (port of ruvector_tpu/graph/csr.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """row_ptr [N+1] int32, col_idx [E] int32, values [E] float32."""

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    values: torch.Tensor
    num_nodes: int

    @property
    def num_edges(self) -> int:
        return self.col_idx.shape[0]

    def row_ids(self) -> torch.Tensor:
        """[E] int32 — source node id of every edge."""
        e = torch.arange(self.num_edges, dtype=torch.int32,
                         device=self.row_ptr.device)
        return (torch.searchsorted(self.row_ptr, e, right=True) - 1).to(torch.int32)

    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    @staticmethod
    def from_edges(src, dst, weight, num_nodes: int, device=None) -> "CSRGraph":
        """Build CSR from a COO edge list on `device`."""
        dev = resolve_device(device)
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if weight is None:
            weight = np.ones(src.shape[0], dtype=np.float32)
        order = np.argsort(src, kind="stable")
        src, dst, weight = src[order], dst[order], np.asarray(weight)[order]
        counts = np.bincount(src, minlength=num_nodes)
        row_ptr = np.zeros(num_nodes + 1, dtype=np.int32)
        np.cumsum(counts, out=row_ptr[1:])
        return CSRGraph(
            row_ptr=torch.from_numpy(row_ptr).to(dev),
            col_idx=torch.from_numpy(dst.astype(np.int32)).to(dev),
            values=torch.from_numpy(weight.astype(np.float32)).to(dev),
            num_nodes=num_nodes)

    def to_padded(self, max_degree: int | None = None):
        """Convert to a padded NeighborGraph on the graph's device."""
        from ruvector_tpu_torch.graph.neighbors import NeighborGraph

        row_ptr = self.row_ptr.cpu().numpy()
        col_idx = self.col_idx.cpu().numpy()
        values = self.values.cpu().numpy()
        deg = row_ptr[1:] - row_ptr[:-1]
        m = int(max_degree or max(int(deg.max(initial=1)), 1))
        n = self.num_nodes
        idx = np.zeros((n, m), dtype=np.int32)
        mask = np.zeros((n, m), dtype=np.float32)
        w = np.zeros((n, m), dtype=np.float32)
        for i in range(n):
            k = min(int(deg[i]), m)
            s = row_ptr[i]
            idx[i, :k] = col_idx[s:s + k]
            w[i, :k] = values[s:s + k]
            mask[i, :k] = 1.0
        dev = self.row_ptr.device
        return NeighborGraph(torch.from_numpy(idx).to(dev),
                             torch.from_numpy(mask).to(dev),
                             torch.from_numpy(w).to(dev))
