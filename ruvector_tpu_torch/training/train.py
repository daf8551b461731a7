"""Training loops: contrastive graph training and query-feedback updates
(port of ruvector_tpu/training/train.py).

Reference: ruvector-gnn/src/training.rs: TrainConfig (batch 256, 64
negatives, tau 0.07, lr 1e-3, flush_threshold 1000, :466-489),
OnlineConfig (local_steps 5, :493-507), per-embedding sgd_step
(:667-677). Anchors are query/result nodes, their graph neighbours the
positives, random non-neighbours the negatives. A train step runs the
RuvectorLayer over the whole graph and the contrastive loss on the updated
embeddings of the batch; the gradient (torch autograd) reaches the layer
parameters and, with train_features, the input features.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ruvector_tpu_torch.graph.neighbors import NeighborGraph
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig, ruvector_layer_apply
from ruvector_tpu_torch.training.ewc import EWCState, ewc_penalty
from ruvector_tpu_torch.training.losses import batched_info_nce, info_nce_loss
from ruvector_tpu_torch.training.optimizers import (
    Optimizer,
    apply_updates,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Contrastive training config (training.rs:466-489 defaults)."""

    batch_size: int = 256
    n_negatives: int = 64
    temperature: float = 0.07
    learning_rate: float = 0.001
    flush_threshold: int = 1000
    train_features: bool = False  # also learn the node embeddings themselves


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Online learning config (training.rs:493-507 defaults)."""

    local_steps: int = 5
    propagate_updates: bool = True


def sgd_step(embedding: torch.Tensor, grad: torch.Tensor, learning_rate: float) -> torch.Tensor:
    """Per-embedding SGD update (training.rs:667-677)."""
    return embedding - learning_rate * grad


def contrastive_loss_fn(params: dict, layer_cfg: RuvectorLayerConfig, features: torch.Tensor,
                        graph: NeighborGraph, anchor_ids: torch.Tensor, neg_ids: torch.Tensor,
                        temperature: float, ewc_state: EWCState | None = None) -> torch.Tensor:
    """Local contrastive loss on the layer's updated embeddings: anchor_ids
    [B], their graph neighbours (masked) as positives, neg_ids [B, Q] as
    negatives (local_contrastive_loss, training.rs:623-641, over a batch)."""
    out = ruvector_layer_apply(params, layer_cfg, features, graph)      # [N, H]
    a = anchor_ids.long()
    loss = batched_info_nce(out[a], out[graph.nbr_idx[a].long()], out[neg_ids.long()],
                            temperature, graph.nbr_mask[a])
    if ewc_state is not None:
        loss = loss + ewc_penalty(ewc_state, params)
    return loss


def _value_and_grad(loss_fn, trainable):
    """(loss, grads like trainable) of loss_fn at trainable."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(trainable)]
    loss = loss_fn(tree_unflatten(trainable, leaves))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(trainable, list(grads))


def make_train_step(layer_cfg: RuvectorLayerConfig, optimizer: Optimizer,
                    cfg: TrainConfig = TrainConfig(), with_ewc: bool = False):
    """The contrastive train step: step(trainable, opt_state, features,
    graph, anchor_ids, neg_ids[, ewc_state]) -> (trainable, opt_state,
    loss). trainable is the layer's parameters or, with
    cfg.train_features, the pair (params, features) (the optimizer state
    must then be made over that pair and `features` is ignored)."""

    def step(trainable, opt_state, features, graph, anchor_ids, neg_ids, ewc_state=None):
        def loss_fn(tr):
            params, feats = tr if cfg.train_features else (tr, features)
            return contrastive_loss_fn(params, layer_cfg, feats, graph, anchor_ids, neg_ids,
                                       cfg.temperature, ewc_state if with_ewc else None)

        loss, grads = _value_and_grad(loss_fn, trainable)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, trainable)
            trainable = apply_updates(trainable, updates)
        return trainable, opt_state, loss

    return step


def make_online_update(layer_cfg: RuvectorLayerConfig, cfg: OnlineConfig = OnlineConfig(),
                       learning_rate: float = 0.001, temperature: float = 0.07):
    """Per-query online learning (training.rs OnlineConfig, sgd_step :667):
    update(params, features, graph, node_id, neg_ids) -> (params, features)
    runs `local_steps` SGD steps of the local contrastive loss around one
    node (its neighbours the positives); only that node's embedding moves,
    and the layer parameters too when cfg.propagate_updates."""

    def update(params, features, graph, node_id: int, neg_ids):
        node = int(node_id)
        for _ in range(cfg.local_steps):
            def loss_fn(tr):
                p, f = tr
                out = ruvector_layer_apply(p, layer_cfg, f, graph)
                return info_nce_loss(out[node], out[graph.nbr_idx[node].long()],
                                     out[neg_ids.long()], temperature)

            _, (g_params, g_feats) = _value_and_grad(loss_fn, (params, features))
            with torch.no_grad():
                if cfg.propagate_updates:
                    params = tree_map(lambda p, g: p - learning_rate * g, params, g_params)
                features = features.clone()
                features[node] -= learning_rate * g_feats[node]
        return params, features

    return update


def sample_negatives(generator: torch.Generator, graph: NeighborGraph, anchor_ids,
                     n_negatives: int) -> torch.Tensor:
    """Host-side uniform negatives avoiding each anchor and its neighbours,
    from an explicit CPU torch.Generator (deterministic given its seed).
    Returns int32 [len(anchor_ids), n_negatives] on the CPU."""
    n = graph.num_nodes
    nbr = graph.nbr_idx.cpu().numpy()
    mask = graph.nbr_mask.cpu().numpy()
    anchors = np.asarray(anchor_ids.cpu() if isinstance(anchor_ids, torch.Tensor) else anchor_ids)
    out = np.empty((len(anchors), n_negatives), np.int32)
    for row, a in enumerate(anchors):
        forbidden = set(nbr[a][mask[a] > 0].tolist())
        forbidden.add(int(a))
        cand = torch.randint(0, n, (n_negatives * 2,), generator=generator).tolist()
        picked = [c for c in cand if c not in forbidden][:n_negatives]
        while len(picked) < n_negatives:
            c = int(torch.randint(0, n, (1,), generator=generator))
            if c not in forbidden:
                picked.append(c)
        out[row] = picked
    return torch.from_numpy(out)


def train_epoch(step_fn, trainable, opt_state, features: torch.Tensor, graph: NeighborGraph,
                cfg: TrainConfig, generator: torch.Generator,
                ewc_state=None) -> tuple[Any, Any, float]:
    """One epoch of contrastive training over all nodes in shuffled
    batches (a CPU torch.Generator draws the order and the negatives)."""
    n = graph.num_nodes
    dev = graph.nbr_idx.device
    order = torch.randperm(n, generator=generator)
    losses = []
    bs = cfg.batch_size
    for start in range(0, n - bs + 1, bs):
        anchors = order[start:start + bs].to(torch.int32)
        negs = sample_negatives(generator, graph, anchors, cfg.n_negatives)
        trainable, opt_state, loss = step_fn(
            trainable, opt_state, features, graph, anchors.to(dev), negs.to(dev),
            *((ewc_state,) if ewc_state is not None else ()))
        losses.append(float(loss))
    return trainable, opt_state, float(np.mean(losses)) if losses else 0.0
