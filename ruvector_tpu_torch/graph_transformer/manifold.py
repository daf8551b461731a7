"""Manifold-aware routing and Riemannian optimization (port of
ruvector_tpu/graph_transformer/manifold.py).

CurvatureAdaptiveRouter (manifold.rs:339-408) routes by Ollivier-Ricci
curvature to the spherical, hyperbolic or euclidean factor;
estimate_ollivier_ricci (:420) is the combinatorial proxy over a dense
one-hot adjacency ([N, N]: for graphs of module scale); geodesic message
passing (:461) averages the neighbors in the tangent space; Riemannian
Adam is Adam on the gradient rescaled by the inverse metric lambda^-2,
applied through exp_map and projected into the Poincare ball.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.hyperbolic import exp_map, log_map, project_to_ball
from ruvector_tpu_torch.graph.neighbors import NeighborGraph
from ruvector_tpu_torch.training.optimizers import tree_map, tree_unflatten


def _lambda(p: torch.Tensor, c: float) -> torch.Tensor:
    """Conformal factor 1/(1 - c||p||^2), the convention of
    attention/hyperbolic.py's log_map (poincare.rs:99-118)."""
    nsq = torch.sum(p * p, dim=-1, keepdim=True)
    return 1.0 / torch.clamp(1.0 - c * nsq, min=1e-6)


@dataclasses.dataclass(frozen=True)
class RoutingWeights:
    spherical: float
    hyperbolic: float
    euclidean: float


class CurvatureAdaptiveRouter:
    """Route by Ollivier-Ricci curvature: negative -> hyperbolic,
    positive -> spherical, flat -> euclidean; a softmax at `temperature`."""

    def __init__(self, neg_threshold: float = -0.1, pos_threshold: float = 0.1,
                 temperature: float = 10.0):
        self.neg_threshold = neg_threshold
        self.pos_threshold = pos_threshold
        self.temperature = temperature

    def route(self, curvature: float) -> RoutingWeights:
        w = self.route_batch(torch.tensor([curvature], dtype=torch.float32))
        return RoutingWeights(float(w[0, 0]), float(w[0, 1]), float(w[0, 2]))

    def route_batch(self, curvatures) -> torch.Tensor:
        """[k] curvatures -> [k, 3] softmax weights (sph, hyp, euc)."""
        c = torch.as_tensor(curvatures, dtype=torch.float32)
        logits = torch.stack([self.temperature * (c - self.pos_threshold),
                              self.temperature * (self.neg_threshold - c),
                              -self.temperature * torch.abs(c)], dim=-1)
        return torch.softmax(logits, dim=-1)


def estimate_ollivier_ricci(graph: NeighborGraph) -> torch.Tensor:
    """Per-node mean Ollivier-Ricci curvature estimate: for edge (i, j),
    kappa ~ overlap(N(i), N(j)) / deg - (1 - 2/deg) for tree-like
    expansion. The overlaps are one product of the [N, N] one-hot
    adjacency with itself."""
    idx, mask = graph.nbr_idx.long(), graph.nbr_mask
    n, m = idx.shape
    deg = torch.clamp(torch.sum(mask, dim=1), min=1.0)
    adj = torch.zeros((n, n), dtype=mask.dtype, device=mask.device)
    rows = torch.arange(n, device=idx.device).repeat_interleave(m)
    adj.index_put_((rows, idx.reshape(-1)), mask.reshape(-1), accumulate=True)
    adj = torch.clamp(adj, max=1.0)
    common = adj @ adj.T                                  # [n, n] shared neighbors
    tri = torch.sum(mask * common[torch.arange(n, device=idx.device)[:, None], idx], dim=1) / deg
    return tri / deg - torch.clamp(1.0 - 2.0 / deg, min=0.0)


def riemannian_adam_init(params):
    return {"m": tree_map(torch.zeros_like, params), "v": tree_map(torch.zeros_like, params),
            "t": 0}


def riemannian_adam_update(params, grads, state, lr: float = 1e-3, b1: float = 0.9,
                           b2: float = 0.999, eps: float = 1e-8, c: float = 1.0):
    """Riemannian Adam on the Poincare ball: the Euclidean gradient times
    the inverse metric 1/lambda^2, Adam moments in the tangent space, the
    step applied with exp_map and projected into the ball. The bias
    corrections are float32 powers, as in the JAX package."""
    t = state["t"] + 1

    def upd(p, g, m, v):
        rg = g / (_lambda(p, c) ** 2)
        m2 = b1 * m + (1 - b1) * rg
        v2 = b2 * v + (1 - b2) * rg * rg
        tt = torch.tensor(float(t), dtype=torch.float32, device=p.device)
        mhat = m2 / (1 - torch.tensor(b1, dtype=torch.float32, device=p.device) ** tt)
        vhat = v2 / (1 - torch.tensor(b2, dtype=torch.float32, device=p.device) ** tt)
        step = -lr * mhat / (torch.sqrt(vhat) + eps)
        return project_to_ball(exp_map(step, p, c), c), m2, v2

    results = []

    def run(p, g, m, v):
        results.append(upd(p, g, m, v))
        return p

    tree_map(run, params, grads, state["m"], state["v"])   # leaves matched by key

    def pick(i):
        return tree_unflatten(params, [r[i] for r in results])

    return pick(0), {"m": pick(1), "v": pick(2), "t": t}


def geodesic_message_passing(x: torch.Tensor, graph: NeighborGraph, c: float = 1.0):
    """Aggregate the neighbors along geodesics (manifold.rs:461), a light
    Frechet mean: log-map the neighbors to the tangent space at each node,
    average over the valid ones, exp-map back."""
    nbr = x[graph.nbr_idx.long()]                         # [n, m, d]
    base = x[:, None, :].expand(nbr.shape)
    d = x.shape[-1]
    tangent = log_map(nbr.reshape(-1, d), base.reshape(-1, d), c).reshape(nbr.shape)
    w = graph.nbr_mask[..., None]
    mean_t = torch.sum(w * tangent, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1.0)
    return project_to_ball(exp_map(mean_t, x, c), c)
