"""Graph convolutional layer, Kipf & Welling (port of
ruvector_tpu/models/gcn.py): messages x_j * w_ij summed over the padded
neighbors, scaled by 1/sqrt(deg), then x @ W + b and ReLU.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.graph.neighbors import NeighborGraph
from ruvector_tpu_torch.nn.core import xavier_normal
from ruvector_tpu_torch.ops.segment import spmm_padded


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    in_features: int
    out_features: int
    normalize: bool = True
    use_bias: bool = True


def gcn_init(seed, cfg: GCNConfig, device=None) -> dict:
    dev = resolve_device(device)
    p = {"kernel": xavier_normal(seed, cfg.in_features, cfg.out_features, dev)}
    if cfg.use_bias:
        p["bias"] = torch.zeros((cfg.out_features,), device=dev)
    return p


def gcn_apply(params: dict, cfg: GCNConfig, features: torch.Tensor, graph: NeighborGraph,
              use_edge_weights: bool = True) -> torch.Tensor:
    """relu(W · norm(sum_j w_ij x_j) + b), norm = 1/sqrt(deg) (1 for
    degree 0)."""
    w = graph.edge_weight if use_edge_weights else graph.nbr_mask
    agg = spmm_padded(features, graph.nbr_idx, w, graph.nbr_mask)   # [N, Din]
    if cfg.normalize:
        deg = torch.sum(graph.nbr_mask, dim=1, keepdim=True)
        norm = torch.where(deg > 0, 1.0 / torch.sqrt(torch.clamp(deg, min=1.0)),
                           torch.ones_like(deg))
        agg = agg * norm
    out = agg @ params["kernel"]
    if "bias" in params:
        out = out + params["bias"]
    return torch.relu(out)
