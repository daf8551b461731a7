"""Batched RuvectorLayer — the flagship GNN embedding-update layer
(port of ruvector_tpu/nn/ruvector_layer.py:42-238).

    x [N, Din] --W_msg--> msg [N, D]
    MHA(query=msg, keys=values=neighbor msgs, mask)
    + edge-weight-normalized mean of the neighbor msgs
    --W_agg--> GRU(input=aggregate, hidden=msg) --(1-dropout)--> LayerNorm

Degree-0 nodes output LayerNorm(msg); zero-weight rows fall back to the
uniform mean; dropout is the deterministic (1 - p) scale.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.graph.neighbors import NeighborGraph
from ruvector_tpu_torch.nn.core import (
    gru_apply,
    gru_init,
    layer_norm_apply,
    layer_norm_init,
    linear_apply,
    linear_init,
    make_generator,
    mha_apply,
    mha_init,
)
from ruvector_tpu_torch.ops.kernels.neighbor_mix import fused_neighbor_mix
from ruvector_tpu_torch.ops.segment import (
    masked_softmax,
    masked_weighted_mean,
    normalized_weights,
)


@dataclasses.dataclass(frozen=True)
class RuvectorLayerConfig:
    input_dim: int
    hidden_dim: int
    heads: int = 4
    dropout: float = 0.0
    eps: float = 1e-5
    # 'float32' (exact reference parity) or 'bfloat16' (neighbor messages
    # and queries rounded to bf16, sums in f32)
    compute_dtype: str = "float32"
    # route the slot-layout attention through the fused neighbor-mix
    # kernel (K3) instead of plain tensor ops
    use_pallas: bool = False

    def __post_init__(self):
        if not 0.0 <= self.dropout <= 1.0:
            raise ValueError(f"dropout must be in [0, 1], got {self.dropout}")
        if self.hidden_dim % self.heads != 0:
            raise ValueError(
                f"hidden_dim ({self.hidden_dim}) must be divisible by heads "
                f"({self.heads})")

    @property
    def cdt(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


def ruvector_layer_init(seed, cfg: RuvectorLayerConfig, device=None,
                        dtype=torch.float32) -> dict:
    """Fresh layer parameters from a seed or torch.Generator, on `device`."""
    g = make_generator(seed)
    return {
        "w_msg": linear_init(g, cfg.input_dim, cfg.hidden_dim, device, dtype),
        "w_agg": linear_init(g, cfg.hidden_dim, cfg.hidden_dim, device, dtype),
        "gru": gru_init(g, cfg.hidden_dim, cfg.hidden_dim, device, dtype),
        "attn": mha_init(g, cfg.hidden_dim, cfg.heads, device, dtype),
        "norm": layer_norm_init(cfg.hidden_dim, device, dtype),
    }


def _folded_attention_and_aggregate(attn_params: dict, heads: int, msg: torch.Tensor,
                                    kv_src: torch.Tensor, nbr_idx: torch.Tensor,
                                    mask: torch.Tensor, edge_weight: torch.Tensor,
                                    use_pallas: bool = False):
    """MHA over neighbors + edge-weighted mean in one pass over the neighbor
    messages, with K and V folded into the query side:
      score_h(i,j) = <W_k_h^T q_h(i), msg_j> + <q_h(i), b_k_h>
      out_h(i)     = W_v_h (sum_j a_h(i,j) msg_j) + (sum_j a_h(i,j)) b_v_h
    so neither K nor V is materialized at [N, M, D]."""
    n, m = nbr_idx.shape
    d = kv_src.shape[-1]
    hd = d // heads
    cdt = kv_src.dtype
    idx = nbr_idx.long()
    q = linear_apply(attn_params["q"], msg).reshape(n, heads, hd)
    wk = attn_params["k"]["kernel"].reshape(d, heads, hd)
    bk = attn_params["k"]["bias"].reshape(heads, hd)
    wv = attn_params["v"]["kernel"].reshape(d, heads, hd)
    bv = attn_params["v"]["bias"].reshape(heads, hd)

    u = torch.einsum("nhf,dhf->nhd", q, wk)                       # [N, H, D]
    score_bias = torch.einsum("nhf,hf->nh", q, bk)                # [N, H]
    scale = 1.0 / (hd ** 0.5)
    wnorm = normalized_weights(edge_weight, mask)

    if use_pallas:
        mixed = fused_neighbor_mix(
            u.float().contiguous(), score_bias.contiguous(),
            kv_src[idx].float().contiguous(), mask.float().contiguous(),
            wnorm.float().contiguous(), heads=heads, scale=scale)
    elif m <= 32:
        # slot route: one [N, D] gather per slot, bf16 products rounded per
        # element as the JAX route does, sums in f32
        uc = u.to(cdt)
        slots = [kv_src[idx[:, j]] for j in range(m)]
        scores = (torch.stack([torch.sum(uc * g[:, None, :], dim=-1) for g in slots],
                              dim=-1).float() + score_bias[..., None]) * scale
        attn_w = masked_softmax(scores, mask[:, None, :], dim=-1)  # [N, H, M]
        allw = torch.cat([attn_w, wnorm[:, None, :]], dim=1).to(cdt)
        mixed = torch.zeros((n, heads + 1, d), dtype=torch.float32, device=msg.device)
        for j in range(m):
            mixed = mixed + (allw[:, :, j][:, :, None] * slots[j][:, None, :]).float()
    else:
        nbr_msg = kv_src[idx].float()                               # [N, M, D]
        scores = (torch.einsum("nhd,nmd->nhm", u.to(cdt).float(), nbr_msg)
                  + score_bias[..., None]) * scale
        attn_w = masked_softmax(scores, mask[:, None, :], dim=-1)
        allw = torch.cat([attn_w, wnorm[:, None, :]], dim=1)
        mixed = torch.einsum("nhm,nmd->nhd", allw.to(cdt).float(), nbr_msg)

    tv, weighted = mixed[:, :heads, :], mixed[:, heads, :]
    o = torch.einsum("nhd,dhf->nhf", tv, wv)                       # [N, H, hd]
    # softmax rows sum to 1 iff the node has a valid neighbor
    has_any = (torch.sum(mask, dim=1) > 0).to(o.dtype)
    o = o + has_any[:, None, None] * bv
    attn_out = linear_apply(attn_params["out"], o.reshape(n, d))
    return attn_out, weighted


def ruvector_layer_apply(params: dict, cfg: RuvectorLayerConfig,
                         features: torch.Tensor, graph: NeighborGraph) -> torch.Tensor:
    """Update all node embeddings: [N, Din] x graph -> [N, D]."""
    msg = linear_apply(params["w_msg"], features)
    gather_src = msg.to(cfg.cdt)
    attn_out, weighted = _folded_attention_and_aggregate(
        params["attn"], cfg.heads, msg, gather_src, graph.nbr_idx,
        graph.nbr_mask, graph.edge_weight, use_pallas=cfg.use_pallas)
    aggregated = linear_apply(params["w_agg"], attn_out + weighted)
    updated = gru_apply(params["gru"], aggregated, msg)
    dropped = updated * (1.0 - cfg.dropout)
    out = layer_norm_apply(params["norm"], dropped, cfg.eps)
    isolated = layer_norm_apply(params["norm"], msg, cfg.eps)
    has_nbrs = torch.sum(graph.nbr_mask, dim=1, keepdim=True) > 0
    return torch.where(has_nbrs, out, isolated)


def ruvector_layer_apply_single(params: dict, cfg: RuvectorLayerConfig,
                                node_embedding: torch.Tensor,
                                neighbor_embeddings: torch.Tensor,
                                edge_weights: torch.Tensor,
                                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Single-node forward with explicit neighbor features [M, Din]."""
    m = neighbor_embeddings.shape[0]
    if mask is None:
        mask = torch.ones((m,), dtype=torch.float32, device=node_embedding.device)
    msg = linear_apply(params["w_msg"], node_embedding[None, :])          # [1, D]
    nbr_msg = linear_apply(params["w_msg"], neighbor_embeddings)[None]    # [1, M, D]
    attn_out = mha_apply(params["attn"], msg, nbr_msg, nbr_msg, mask[None, :], cfg.heads)
    weighted = masked_weighted_mean(nbr_msg, edge_weights[None, :], mask[None, :])
    aggregated = linear_apply(params["w_agg"], attn_out + weighted)
    updated = gru_apply(params["gru"], aggregated, msg)
    dropped = updated * (1.0 - cfg.dropout)
    out = layer_norm_apply(params["norm"], dropped, cfg.eps)
    isolated = layer_norm_apply(params["norm"], msg, cfg.eps)
    return torch.where(torch.sum(mask) > 0, out, isolated)[0]
