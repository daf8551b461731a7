"""Generic message passing (port of ruvector_tpu/models/message_passing.py).

The message / aggregate / update protocol that GCN and GraphSAGE
implement, with the sum, mean and max aggregators, over the padded
neighbor layout. A custom layer supplies the three callables.
"""

from __future__ import annotations

from typing import Callable

import torch

from ruvector_tpu_torch.graph.neighbors import NeighborGraph


def sum_aggregate(messages: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[N, M, D] masked sum -> [N, D]."""
    return torch.sum(messages * mask[..., None], dim=1)


def mean_aggregate(messages: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    deg = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
    return torch.sum(messages * mask[..., None], dim=1) / deg


def max_aggregate(messages: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked max; a row with no neighbor gives zeros."""
    neg = torch.where(mask[..., None] > 0, messages, torch.full_like(messages, -torch.inf))
    out = torch.amax(neg, dim=1)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


AGGREGATORS: dict[str, Callable] = {
    "sum": sum_aggregate,
    "mean": mean_aggregate,
    "max": max_aggregate,
}


def propagate(features: torch.Tensor, graph: NeighborGraph,
              message_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
              aggregate: str | Callable = "sum",
              update_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
              ) -> torch.Tensor:
    """One message-passing round:

    messages = message_fn(neighbor_features [N, M, D], edge_weights [N, M])
    agg      = aggregate(messages, mask)
    out      = update_fn(agg, self_features)

    Defaults: message = x_j * w_ij; aggregate = sum; update = agg.
    """
    nbr = features[graph.nbr_idx.long()]                 # [N, M, D]
    if message_fn is None:
        messages = nbr * graph.edge_weight[..., None]
    else:
        messages = message_fn(nbr, graph.edge_weight)
    agg_fn = AGGREGATORS[aggregate] if isinstance(aggregate, str) else aggregate
    aggregated = agg_fn(messages, graph.nbr_mask)
    if update_fn is None:
        return aggregated
    return update_fn(aggregated, features)
