"""Hyperbolic (Poincaré-ball) index with tangent-space pruning (port of
ruvector_tpu/index/hyperbolic_hnsw.py).

Reference: ruvector-hyperbolic-hnsw, whose speed trick (lib.rs:46-50) is:
1. precompute tangent coordinates u = log_c(x) at a shard centroid c
2. prune candidates with cheap Euclidean distance in tangent space
3. exact Poincaré distance only on the top candidates.

Both stages are batched products on `device` (default: the CUDA card):
the tangent prefilter is one [B, D] x [D, N] distance computation, the
exact Poincaré re-rank runs on the filtered top-C candidates. Rankings
use a stable sort, as jnp.argsort does, so equal distances keep index
order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.attention.hyperbolic import log_map, poincare_distance, project_to_ball
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.ops.distance import pairwise_euclidean


@dataclasses.dataclass(frozen=True)
class HyperbolicConfig:
    dim: int
    curvature: float = 1.0
    prune_candidates: int = 64    # tangent-space prefilter width


class HyperbolicIndex:
    """Flat hyperbolic index with tangent pruning (the HNSW graph layer of
    the reference is orthogonal: this provides the geometric search core;
    compose with HnswIndex over tangent coords for sublinear search)."""

    def __init__(self, config: HyperbolicConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._points: list[np.ndarray] = []
        self._centroid: torch.Tensor | None = None
        self._tangent: torch.Tensor | None = None
        self._dirty = True

    def __len__(self):
        return len(self._points)

    def _project(self, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        return project_to_ball(x, self.config.curvature)

    def insert(self, point: np.ndarray) -> int:
        self._points.append(self._project(point).cpu().numpy())
        self._dirty = True
        return len(self._points) - 1

    def insert_batch(self, points: np.ndarray) -> list[int]:
        start = len(self._points)
        self._points.extend(list(self._project(points).cpu().numpy()))
        self._dirty = True
        return list(range(start, len(self._points)))

    def _refresh(self):
        """Recompute centroid + tangent cache (tangent.rs:47-134)."""
        if not self._dirty:
            return
        pts = torch.from_numpy(np.stack(self._points)).to(self.device)
        # Euclidean mean projected into the ball approximates the Fréchet
        # mean well enough for pruning (exactness only matters for re-rank)
        centroid = project_to_ball(torch.mean(pts, dim=0), self.config.curvature)
        self._centroid = centroid
        self._tangent = log_map(pts, centroid[None, :], self.config.curvature)
        self._pts_dev = pts
        self._dirty = False

    def search(self, query: np.ndarray, k: int = 10) -> list[tuple[int, float]]:
        """Two-stage: tangent Euclidean prefilter -> exact Poincaré rank."""
        if not self._points:
            return []
        self._refresh()
        c = self.config.curvature
        q = self._project(query)
        q_t = log_map(q[None, :], self._centroid[None, :], c)     # [1, D]

        n = len(self._points)
        cand = min(max(self.config.prune_candidates, k), n)
        d_tan = pairwise_euclidean(q_t, self._tangent)[0]          # [N]
        top = torch.argsort(d_tan, stable=True)[:cand]

        exact = poincare_distance(q[None, :], self._pts_dev[top], c)  # [cand]
        order = torch.argsort(exact, stable=True)[:k]
        ids = top[order].cpu().numpy()
        dists = exact[order].cpu().numpy()
        return [(int(i), float(d)) for i, d in zip(ids, dists)]

    def search_exact(self, query: np.ndarray, k: int = 10) -> list[tuple[int, float]]:
        """Brute-force exact Poincaré ranking (the pruning oracle)."""
        self._refresh()
        c = self.config.curvature
        q = self._project(query)
        d = poincare_distance(q[None, :], self._pts_dev, c)
        order = torch.argsort(d, stable=True)[:k]
        d_host = d[order].cpu().numpy()
        return [(int(i), float(di)) for i, di in zip(order.cpu().numpy(), d_host)]
