"""Message-passing ops in two layouts (port of ruvector_tpu/ops/segment.py).

- padded `[N, M]` (NeighborGraph): masked softmax, weighted mean, SpMM and
  SDDMM as masked dense reductions (`:21-76`);
- CSR (CSRGraph): SpMM, SDDMM and the row-wise softmax over per-edge
  scores (`:82-104`). JAX's `segment_sum` becomes `index_add_` and
  `segment_max` becomes `scatter_reduce("amax")` over a `-inf` fill. On
  the card `index_add_` adds with atomics, so the CSR sums change order
  from run to run: compare them with a tolerance.
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


# ---------------------------------------------------------------------------
# CSR layout
# ---------------------------------------------------------------------------

def _segment_sum(values: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add_(0, rows, values)


def spmm_csr(graph, features: torch.Tensor) -> torch.Tensor:
    """CSR SpMM: out[i] = sum_{e in row i} values[e] * x[col_idx[e]]."""
    rows = graph.row_ids().long()
    contrib = features[graph.col_idx.long()] * graph.values[:, None]
    return _segment_sum(contrib, rows, graph.num_nodes)


def sddmm_csr(graph, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """CSR SDDMM: per-edge scores e -> <q[row(e)], k[col(e)]>. Returns [E]."""
    rows = graph.row_ids().long()
    return torch.sum(q[rows] * k[graph.col_idx.long()], dim=-1)


def segment_softmax_csr(graph, scores: torch.Tensor) -> torch.Tensor:
    """Row-wise softmax over per-edge scores [E] -> [E]. A row without
    edges has max -inf, which becomes 0 as in JAX (`segment.py:100`)."""
    rows = graph.row_ids().long()
    n = graph.num_nodes
    fill = torch.full((n,), -torch.inf, dtype=scores.dtype, device=scores.device)
    row_max = fill.scatter_reduce(0, rows, scores, "amax", include_self=False)
    row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    e = torch.exp(scores - row_max[rows])
    denom = torch.clamp(_segment_sum(e, rows, n), min=1e-10)
    return e / denom[rows]
