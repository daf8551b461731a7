"""RuvectorNet — a stack of RuvectorLayers over the neighbor graph
(port of ruvector_tpu/models/ruvector_net.py). The first layer maps
input_dim -> hidden, the rest hidden -> hidden.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ruvector_tpu_torch.graph.neighbors import NeighborGraph
from ruvector_tpu_torch.nn.core import make_generator
from ruvector_tpu_torch.nn.ruvector_layer import (
    RuvectorLayerConfig,
    ruvector_layer_apply,
    ruvector_layer_init,
)


@dataclasses.dataclass(frozen=True)
class RuvectorNetConfig:
    input_dim: int
    hidden_dim: int
    num_layers: int = 2
    heads: int = 4
    dropout: float = 0.0
    remat: bool = False   # recompute each layer's activations in backward

    def layer_cfgs(self) -> list[RuvectorLayerConfig]:
        return [RuvectorLayerConfig(
            input_dim=self.input_dim if i == 0 else self.hidden_dim,
            hidden_dim=self.hidden_dim, heads=self.heads, dropout=self.dropout)
            for i in range(self.num_layers)]


def ruvector_net_init(seed, cfg: RuvectorNetConfig, device=None) -> list[dict]:
    g = make_generator(seed)
    return [ruvector_layer_init(g, lc, device) for lc in cfg.layer_cfgs()]


def ruvector_net_apply(params: list[dict], cfg: RuvectorNetConfig,
                       features: torch.Tensor, graph: NeighborGraph) -> torch.Tensor:
    x = features
    for p, lc in zip(params, cfg.layer_cfgs()):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(ruvector_layer_apply, p, lc, x, graph, use_reentrant=False)
        else:
            x = ruvector_layer_apply(p, lc, x, graph)
    return x
