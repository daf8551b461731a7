"""Graph attention layer over the neighbor graph (port of
ruvector_tpu/models/gat.py): the edge-featured (GATv2-style) mechanism on
the padded layout, each node attending over its neighbors with the scalar
edge weight lifted to a 1-d edge feature.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.edge_featured import (
    EdgeFeaturedConfig,
    edge_featured_apply,
    edge_featured_init,
)
from ruvector_tpu_torch.graph.neighbors import NeighborGraph


@dataclasses.dataclass(frozen=True)
class GATConfig:
    node_dim: int
    num_heads: int = 4
    edge_dim: int = 1
    negative_slope: float = 0.2
    concat_heads: bool = True
    residual: bool = True

    def attn_cfg(self) -> EdgeFeaturedConfig:
        return EdgeFeaturedConfig(node_dim=self.node_dim, edge_dim=self.edge_dim,
                                  num_heads=self.num_heads, concat_heads=self.concat_heads,
                                  negative_slope=self.negative_slope)


def gat_init(seed, cfg: GATConfig, device=None) -> dict:
    return {"attn": edge_featured_init(seed, cfg.attn_cfg(), device)}


def gat_apply(params: dict, cfg: GATConfig, features: torch.Tensor,
              graph: NeighborGraph) -> torch.Tensor:
    """The residual applies only where the output's shape is the input's."""
    nbr = features[graph.nbr_idx.long()]                 # [N, M, D]
    edges = graph.edge_weight[..., None]                 # [N, M, 1]
    out = edge_featured_apply(params["attn"], cfg.attn_cfg(), features, nbr, nbr,
                              graph.nbr_mask, edges)
    if cfg.residual and out.shape == features.shape:
        out = out + features
    return out
