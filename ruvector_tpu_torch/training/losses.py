"""Loss functions: MSE, CE, BCE, InfoNCE, local contrastive (port of
ruvector_tpu/training/losses.py).

Reference: ruvector-gnn/src/training.rs, losses :250-430, info_nce_loss
:541-590, local_contrastive_loss :623-641. EPS = 1e-7 clamps,
log-sum-exp stabilisation, cosine similarities scaled by 1/temperature
(default 0.07).
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.ops.distance import cosine_similarity

EPS = 1e-7


def mse_loss(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """mean((pred - target)^2) (training.rs:354-357)."""
    return torch.mean(torch.square(predictions - targets))


def cross_entropy_loss(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-sum(targets * log(max(pred, eps))) / rows (training.rs:371-375);
    targets one-hot, predictions probabilities."""
    return -torch.sum(targets * torch.log(torch.clamp(predictions, min=EPS))) / predictions.shape[0]


def binary_cross_entropy_loss(predictions: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCE with (eps, 1 - eps) clamping (training.rs:396-407)."""
    p = torch.clamp(predictions, EPS, 1.0 - EPS)
    return -torch.mean(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))


def info_nce_loss(anchor: torch.Tensor, positives: torch.Tensor, negatives: torch.Tensor,
                  temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE averaged over positives (training.rs:541-590): per positive,
    -(pos_sim - logsumexp([pos_sim, neg_sims])), similarities / temperature.
    anchor [D], positives [P, D], negatives [Q, D]."""
    pos = cosine_similarity(anchor[None, :], positives) / temperature      # [P]
    neg = cosine_similarity(anchor[None, :], negatives) / temperature      # [Q]
    logits = torch.cat([pos[:, None], neg[None, :].expand(pos.shape[0], -1)], dim=1)
    return torch.mean(torch.logsumexp(logits, dim=1) - pos)


def local_contrastive_loss(node_embedding, neighbor_embeddings, non_neighbor_embeddings,
                           temperature: float = 0.07) -> torch.Tensor:
    """Graph-local InfoNCE: neighbours are the positives, non-neighbours the
    negatives (training.rs:623-641)."""
    return info_nce_loss(node_embedding, neighbor_embeddings, non_neighbor_embeddings,
                         temperature)


def batched_info_nce(anchors: torch.Tensor, positives: torch.Tensor, negatives: torch.Tensor,
                     temperature: float = 0.07,
                     pos_mask: torch.Tensor | None = None) -> torch.Tensor:
    """InfoNCE over B anchors at once: anchors [B, D], positives [B, P, D],
    negatives [B, Q, D], pos_mask [B, P] (1 = valid positive). Each
    anchor's mean over its valid positives, averaged over the batch;
    anchors without a valid positive contribute 0 (training.rs:547-549)."""
    b, p, _ = positives.shape
    pos = cosine_similarity(anchors[:, None, :], positives) / temperature     # [B, P]
    neg = cosine_similarity(anchors[:, None, :], negatives) / temperature     # [B, Q]
    logits = torch.cat([pos[:, :, None], neg[:, None, :].expand(b, p, neg.shape[1])], dim=-1)
    per_pos = torch.logsumexp(logits, dim=-1) - pos                           # [B, P]
    if pos_mask is None:
        pos_mask = torch.ones((b, p), dtype=anchors.dtype, device=anchors.device)
    count = torch.sum(pos_mask, dim=1)
    per_anchor = torch.sum(per_pos * pos_mask, dim=1) / torch.clamp(count, min=1.0)
    return torch.mean(torch.where(count > 0, per_anchor, torch.zeros_like(per_anchor)))
