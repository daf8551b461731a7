"""Padded-layout message-passing ops: masked softmax, weighted mean,
SpMM and SDDMM (port of ruvector_tpu/ops/segment.py:21-76).

The CSR-layout functions of the JAX module are not ported yet.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over `dim` treating mask==0 entries as excluded.

    Matches the reference's epsilon-guarded softmax: masked entries are
    filled with -1e30 (not -inf), the exp-sum is clamped below at 1e-10,
    and fully-masked rows yield zeros — never NaN, which
    `torch.softmax` over -inf would give.
    """
    valid = mask > 0
    s = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = torch.clamp(torch.amax(s, dim=dim, keepdim=True), min=NEG_INF)
    e = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    denom = torch.clamp(torch.sum(e, dim=dim, keepdim=True), min=1e-10)
    return e / denom


def normalized_weights(weights: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row edge weights normalized to sum 1, with the uniform fallback
    over valid neighbors for rows whose weights sum to <= 0."""
    w = weights * mask
    wsum = torch.sum(w, dim=1, keepdim=True)
    deg = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
    safe = torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    return torch.where(wsum > 0, w / safe, mask / deg)


def masked_weighted_mean(nbr_feats: torch.Tensor, weights: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """[N, M, D] x [N, M] -> [N, D] edge-weight-normalized neighbor mean."""
    wnorm = normalized_weights(weights, mask)
    return torch.einsum("nm,nmd->nd", wnorm, nbr_feats)


def spmm_padded(features: torch.Tensor, nbr_idx: torch.Tensor,
                weights: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j w_ij * x[nbr[i, j]] over the padded layout."""
    gathered = features[nbr_idx.long()]
    return torch.einsum("nm,nmd->nd", weights * mask, gathered)


def sddmm_padded(q: torch.Tensor, k_feats: torch.Tensor, nbr_idx: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """scores[i, j] = <q[i], k[nbr[i, j]]>; padding positions return 0."""
    kg = k_feats[nbr_idx.long()]
    return torch.einsum("nd,nmd->nm", q, kg) * mask
