"""Graph transformer block over the NeighborGraph (port of
ruvector_tpu/graph_transformer/block.py).

Pre-norm layers: x += edge-featured graph attention (GATv2 over the
neighbors, the edge weight as a 1-d edge feature); x += FFN(LN(x)) with
the tanh GELU (`jax.nn.gelu`'s default).
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.edge_featured import (
    EdgeFeaturedConfig,
    edge_featured_apply,
    edge_featured_init,
)
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.graph.neighbors import NeighborGraph
from ruvector_tpu_torch.nn.core import (
    layer_norm_apply,
    layer_norm_init,
    linear_apply,
    linear_init,
    make_generator,
)


@dataclasses.dataclass(frozen=True)
class GraphTransformerConfig:
    dim: int
    num_heads: int = 4
    ffn_mult: int = 4
    num_layers: int = 2
    edge_dim: int = 1
    negative_slope: float = 0.2

    def attn_cfg(self) -> EdgeFeaturedConfig:
        return EdgeFeaturedConfig(node_dim=self.dim, edge_dim=self.edge_dim,
                                  num_heads=self.num_heads, concat_heads=True,
                                  negative_slope=self.negative_slope)


def graph_transformer_init(seed, cfg: GraphTransformerConfig, device=None) -> list[dict]:
    """One dict a layer: attn, ln1, ln2, ffn_in, ffn_out (the JAX layout)."""
    dev = resolve_device(device)
    g = make_generator(seed)
    return [{"attn": edge_featured_init(g, cfg.attn_cfg(), dev),
             "ln1": layer_norm_init(cfg.dim, dev),
             "ln2": layer_norm_init(cfg.dim, dev),
             "ffn_in": linear_init(g, cfg.dim, cfg.dim * cfg.ffn_mult, dev),
             "ffn_out": linear_init(g, cfg.dim * cfg.ffn_mult, cfg.dim, dev)}
            for _ in range(cfg.num_layers)]


def graph_transformer_apply(params: list[dict], cfg: GraphTransformerConfig,
                            features: torch.Tensor, graph: NeighborGraph) -> torch.Tensor:
    """Pre-norm blocks: x += attn(LN(x), neighbors); x += FFN(LN(x))."""
    x = features
    edges = graph.edge_weight[..., None]
    idx = graph.nbr_idx.long()
    for p in params:
        h = layer_norm_apply(p["ln1"], x)
        nbr = h[idx]
        x = x + edge_featured_apply(p["attn"], cfg.attn_cfg(), h, nbr, nbr, graph.nbr_mask,
                                    edges)
        h2 = layer_norm_apply(p["ln2"], x)
        x = x + linear_apply(p["ffn_out"], torch.nn.functional.gelu(
            linear_apply(p["ffn_in"], h2), approximate="tanh"))
    return x
