"""Self-organizing graph structures: morphogenetic fields, growth and
coarsening (port of ruvector_tpu/graph_transformer/self_organizing.py).

MorphogeneticField (self_organizing.rs:37-91): Gray-Scott
activator/inhibitor reaction-diffusion on the graph Laplacian, a Python
loop of elementwise and neighbor-sum steps. DevelopmentalProgram (:218)
grows edges on the host (shapes change). GraphCoarsener (:425) reuses the
AMG aggregation of solver/bmssp.py; its means over aggregates are
`index_add_` sums. The initial inhibitor seeds are `jax.random.uniform`
draws in the JAX package: the port takes the uniforms as an argument, or
draws its own from a seeded CPU generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.graph.neighbors import NeighborGraph
from ruvector_tpu_torch.solver.bmssp import _coarsen


@dataclasses.dataclass(frozen=True)
class SelfOrganizingConfig:
    diffusion_a: float = 0.16
    diffusion_b: float = 0.08
    feed: float = 0.035
    kill: float = 0.065
    dt: float = 1.0
    growth_threshold: float = 0.5


class MorphogeneticField:
    """Gray-Scott activator (a) / inhibitor (b) dynamics on the graph."""

    def __init__(self, config: SelfOrganizingConfig = SelfOrganizingConfig()):
        self.config = config

    def init_state(self, num_nodes: int, seed: int = 0, uniform=None, device=None):
        """a = 1; b = 0.25 where a uniform draw is below 0.05, else 0
        (`uniform` [n] if given, else drawn from a seeded CPU generator)."""
        dev = resolve_device(device)
        if uniform is None:
            uniform = torch.rand(num_nodes, generator=torch.Generator().manual_seed(int(seed)))
        u = torch.as_tensor(uniform, dtype=torch.float32).to(dev)
        a = torch.ones(num_nodes, dtype=torch.float32, device=dev)
        return a, torch.where(u < 0.05, torch.full_like(u, 0.25), torch.zeros_like(u))

    def step(self, a, b, graph: NeighborGraph, steps: int = 50):
        """Run the reaction-diffusion; returns (a, b, growth scores [n]).
        The growth score is the inhibitor's concentration, where structure
        condenses (self_organizing.rs:91)."""
        cfg = self.config
        mask = graph.nbr_mask
        idx = graph.nbr_idx.long()
        deg = torch.clamp(torch.sum(mask, dim=1), min=1.0)

        def lap(x):
            return torch.sum(mask * x[idx], dim=1) / deg - x

        for _ in range(steps):
            ab2 = a * b * b
            a2 = a + cfg.dt * (cfg.diffusion_a * lap(a) - ab2 + cfg.feed * (1.0 - a))
            b2 = b + cfg.dt * (cfg.diffusion_b * lap(b) + ab2 - (cfg.kill + cfg.feed) * b)
            a, b = torch.clamp(a2, 0.0, 1.5), torch.clamp(b2, 0.0, 1.5)
        return a, b, b


@dataclasses.dataclass
class GrowthResult:
    new_edges: np.ndarray      # [k, 2] grown edges
    budget_used: int


class DevelopmentalProgram:
    """Host-side growth: connect high-score nodes to a neighbor of their
    strongest neighbor, within a growth budget (self_organizing.rs:218-229)."""

    def __init__(self, max_growth_budget: int = 64, threshold: float = 0.2):
        self.max_growth_budget = max_growth_budget
        self.threshold = threshold

    def grow(self, graph: NeighborGraph, scores) -> GrowthResult:
        scores = scores.cpu().numpy() if isinstance(scores, torch.Tensor) else np.asarray(scores)
        idx = graph.nbr_idx.cpu().numpy()
        mask = graph.nbr_mask.cpu().numpy() > 0
        candidates = np.argsort(-scores)
        existing = {(i, int(j)) for i in range(len(idx)) for j in idx[i][mask[i]]}
        new_edges = []
        for i in candidates:
            if scores[i] < self.threshold or len(new_edges) >= self.max_growth_budget:
                break
            # two hops: the neighbors of my strongest neighbor
            nb = idx[i][mask[i]]
            if len(nb) == 0:
                continue
            best = nb[np.argmax(scores[nb])]
            for two_hop in idx[best][mask[best]]:
                t = int(two_hop)
                if t != i and (int(i), t) not in existing:
                    new_edges.append((int(i), t))
                    existing.add((int(i), t))
                    break
        return GrowthResult(new_edges=np.asarray(new_edges, np.int64).reshape(-1, 2),
                            budget_used=len(new_edges))


@dataclasses.dataclass
class CoarsenResult:
    agg: np.ndarray            # [n] aggregate id per node
    num_coarse: int
    coarse_features: torch.Tensor


class GraphCoarsener:
    """Aggregation coarsening (self_organizing.rs:425) on the AMG
    aggregation; uncoarsen broadcasts coarse features back."""

    def __init__(self, ratio: float = 0.5):
        self.ratio = ratio

    def coarsen(self, graph: NeighborGraph, features: torch.Tensor) -> CoarsenResult:
        idx = graph.nbr_idx.cpu().numpy()
        mask = graph.nbr_mask.cpu().numpy() > 0
        n = idx.shape[0]
        rows = np.repeat(np.arange(n), idx.shape[1])[mask.ravel()]
        cols = idx.ravel()[mask.ravel()]
        # the diagonal too, so that the strength of a connection is defined
        rows = np.concatenate([rows, np.arange(n)])
        cols = np.concatenate([cols, np.arange(n)])
        vals = np.concatenate([-np.ones(len(rows) - n), np.full(n, 2.0)])
        agg = _coarsen(rows, cols, vals, n)
        nc = int(agg.max()) + 1
        agg_t = torch.from_numpy(agg).to(features.device)
        coarse = torch.zeros((nc, features.shape[1]), dtype=features.dtype,
                             device=features.device).index_add_(0, agg_t, features)
        counts = torch.zeros(nc, dtype=features.dtype, device=features.device).index_add_(
            0, agg_t, torch.ones(n, dtype=features.dtype, device=features.device))
        return CoarsenResult(agg=agg, num_coarse=nc, coarse_features=coarse / counts[:, None])

    def uncoarsen(self, result: CoarsenResult, coarse_features: torch.Tensor) -> torch.Tensor:
        return coarse_features[torch.from_numpy(result.agg).to(coarse_features.device)]
