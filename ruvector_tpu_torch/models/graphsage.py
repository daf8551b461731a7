"""GraphSAGE with fixed-fanout neighbor sampling (port of
ruvector_tpu/models/graphsage.py).

Sampling runs on the host from a seed and gives an [N, F] index tensor;
the layer is a masked mean or max over the samples, then
relu(agg @ W_n + x @ W_s) and an optional L2 normalisation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.graph.neighbors import NeighborGraph
from ruvector_tpu_torch.nn.core import make_generator, xavier_normal


@dataclasses.dataclass(frozen=True)
class GraphSAGEConfig:
    in_features: int
    out_features: int
    num_samples: int = 10
    aggregator: str = "mean"   # mean | max
    normalize: bool = True


def graphsage_init(seed, cfg: GraphSAGEConfig, device=None) -> dict:
    g = make_generator(seed)
    return {"w_neighbor": xavier_normal(g, cfg.in_features, cfg.out_features, device),
            "w_self": xavier_normal(g, cfg.in_features, cfg.out_features, device)}


def sample_fanout(graph: NeighborGraph, fanout: int,
                  seed: int = 42) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform fixed-fanout sampling on the host: ([N, fanout] int32 ids,
    [N, fanout] float32 mask) on the graph's device. A node of degree <=
    fanout keeps all its neighbors; any other draws `fanout` of them
    without replacement from one `np.random.default_rng(seed)`, node by
    node in index order (the JAX package's Python route, id for id)."""
    nbr = graph.nbr_idx.cpu().numpy()
    mask = graph.nbr_mask.cpu().numpy() > 0
    rng = np.random.default_rng(seed)
    n = nbr.shape[0]
    out_idx = np.zeros((n, fanout), np.int32)
    out_mask = np.zeros((n, fanout), np.float32)
    for i in range(n):
        nbrs = nbr[i][mask[i]]
        if len(nbrs) <= fanout:
            out_idx[i, :len(nbrs)] = nbrs
            out_mask[i, :len(nbrs)] = 1.0
        else:
            out_idx[i] = rng.choice(nbrs, size=fanout, replace=False)
            out_mask[i] = 1.0
    dev = graph.nbr_idx.device
    return torch.from_numpy(out_idx).to(dev), torch.from_numpy(out_mask).to(dev)


@dataclasses.dataclass(frozen=True)
class GraphSAGENetConfig:
    """Multi-layer GraphSAGE with a fanout per layer."""

    in_features: int
    hidden_features: int
    out_features: int
    fanouts: tuple = (10, 10)
    aggregator: str = "mean"
    normalize: bool = True

    def layer_cfgs(self) -> list[GraphSAGEConfig]:
        n = len(self.fanouts)
        return [GraphSAGEConfig(
            in_features=self.in_features if i == 0 else self.hidden_features,
            out_features=self.out_features if i == n - 1 else self.hidden_features,
            num_samples=f, aggregator=self.aggregator, normalize=self.normalize)
            for i, f in enumerate(self.fanouts)]


def graphsage_net_init(seed, cfg: GraphSAGENetConfig, device=None) -> list[dict]:
    g = make_generator(seed)
    return [graphsage_init(g, lc, device) for lc in cfg.layer_cfgs()]


def graphsage_net_apply(params: list[dict], cfg: GraphSAGENetConfig, features: torch.Tensor,
                        graph: NeighborGraph, seed: int = 42) -> torch.Tensor:
    """Full-graph forward: layer i samples its fanout with seed + i."""
    x = features
    for i, (p, lc) in enumerate(zip(params, cfg.layer_cfgs())):
        idx, mask = sample_fanout(graph, lc.num_samples, seed=seed + i)
        x = graphsage_apply(p, lc, x, idx, mask)
    return x


def graphsage_apply(params: dict, cfg: GraphSAGEConfig, features: torch.Tensor,
                    sampled_idx: torch.Tensor, sampled_mask: torch.Tensor) -> torch.Tensor:
    """features [N, Din], sampled_idx and sampled_mask [N, F] ->
    relu(agg(neighbors) @ W_n + x @ W_s), L2-normalised rows if asked.
    A node with no sample aggregates to zeros."""
    nbr_feats = features[sampled_idx.long()]             # [N, F, Din]
    m = sampled_mask[..., None]
    if cfg.aggregator == "mean":
        deg = torch.clamp(torch.sum(sampled_mask, dim=1, keepdim=True), min=1.0)
        agg = torch.sum(nbr_feats * m, dim=1) / deg
    elif cfg.aggregator == "max":
        agg = torch.amax(torch.where(m > 0, nbr_feats, torch.full_like(nbr_feats, -torch.inf)),
                         dim=1)
        agg = torch.where(torch.isfinite(agg), agg, torch.zeros_like(agg))
    else:
        raise ValueError(f"unknown aggregator {cfg.aggregator}")
    has = torch.sum(sampled_mask, dim=1, keepdim=True) > 0
    agg = torch.where(has, agg, torch.zeros_like(agg))

    combined = torch.relu(agg @ params["w_neighbor"] + features @ params["w_self"])
    if cfg.normalize:
        norm = torch.linalg.vector_norm(combined, dim=-1, keepdim=True)
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        combined = torch.where(norm > 0, combined / safe, combined)
    return combined
