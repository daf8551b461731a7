"""Flat (brute-force) index: exact top-k by one batched product (port of
ruvector_tpu/index/flat.py).

Distances are one [Q, D] x [D, N] product on the device, which for a
corpus that fits on the card is exact and needs no index maintenance.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.ops.distance import pairwise_cosine, pairwise_euclidean


class FlatIndex:
    """Exact top-k over a feature matrix kept on `device` (default: the
    CUDA card)."""

    def __init__(self, dim: int, metric: str = "cosine", device=None):
        self.dim = dim
        self.metric = metric
        self.device = resolve_device(device)
        self._rows: list[np.ndarray] = []
        self._matrix: torch.Tensor | None = None       # device copy of the rows
        # an insert on one thread and a search on another (the HTTP server)
        # must not leave a copy of fewer rows in place
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._rows)

    def add_batch(self, vectors: np.ndarray, num_threads: int = 0):
        v = np.atleast_2d(np.asarray(vectors, np.float32))
        if v.shape[1] != self.dim:
            raise ValueError(f"vectors have width {v.shape[1]}, the index {self.dim}")
        with self._lock:
            self._rows.extend(v)
            self._matrix = None                        # stale: rebuilt on next search

    add = add_batch

    def _mat(self) -> torch.Tensor:
        with self._lock:
            if self._matrix is None:
                self._matrix = torch.from_numpy(np.stack(self._rows)).to(self.device)
            return self._matrix

    def search_batch(self, queries: np.ndarray, k: int = 10, ef: int | None = None,
                     num_threads: int = 0):
        """(ids [Q, k] int32, dists [Q, k] float32), padded with -1 / inf
        where k exceeds the corpus. Cosine gives 2 - 2 sim (the squared L2
        distance of the normalized vectors, HNSW's convention), Euclidean
        the squared L2 distance."""
        q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(self.device)
        mat = self._mat()
        if self.metric == "cosine":
            d = 2.0 - 2.0 * pairwise_cosine(q, mat)
        else:
            d = pairwise_euclidean(q, mat)
        k_eff = min(k, mat.shape[0])
        neg_d, idx = torch.topk(-d, k_eff, dim=1, sorted=True)
        ids = np.full((q.shape[0], k), -1, np.int32)
        dists = np.full((q.shape[0], k), np.inf, np.float32)
        ids[:, :k_eff] = idx.cpu().numpy()
        dists[:, :k_eff] = -neg_d.cpu().numpy()
        return ids, dists

    def search(self, query, k: int = 10, ef: int | None = None):
        ids, dists = self.search_batch(np.asarray(query)[None], k, ef)
        return ids[0], dists[0]
