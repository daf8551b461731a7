"""RuvectorLayer forward on the block-dense layout
(port of ruvector_tpu/nn/block_dense_layer.py:27-218).

Same math as nn/ruvector_layer.py, different data movement: per-edge
gathers become dense products against each block's local table.
Three routes:
  * the scan route — a loop over blocks with plain tensor ops;
  * use_pallas=True — the block-dense attention kernel (K2), epilogue in
    plain tensor ops;
  * ruvector_layer_apply_block_dense_fused — msg projection plus ONE
    kernel (K1) for attention, out-projection, aggregate, GRU, LayerNorm.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.graph.block_dense import BlockDenseGraph
from ruvector_tpu_torch.nn.core import gru_apply, layer_norm_apply, linear_apply
from ruvector_tpu_torch.nn.ruvector_layer import RuvectorLayerConfig
from ruvector_tpu_torch.ops.kernels.block_dense_attn import (
    block_dense_attention,
    block_dense_layer_fused,
)
from ruvector_tpu_torch.ops.segment import masked_softmax


def _f32(x: torch.Tensor | None) -> torch.Tensor | None:
    """The kernels read wd and lm as float32 (a bf16 wdense widens exactly)."""
    return None if x is None else x.float().contiguous()


def ruvector_layer_apply_block_dense(params: dict, cfg: RuvectorLayerConfig,
                                     features: torch.Tensor, bdg: BlockDenseGraph,
                                     use_pallas: bool = False) -> torch.Tensor:
    """Update all node embeddings: [Npad, Din] x block-dense graph -> [Npad, D]."""
    nb, b = bdg.n_blocks, bdg.block
    heads = cfg.heads
    d = cfg.hidden_dim
    hd = d // heads
    cdt = cfg.cdt

    msg = linear_apply(params["w_msg"], features)                  # [Npad, D]
    gather_src = msg.to(cdt)
    q = linear_apply(params["attn"]["q"], msg).reshape(-1, heads, hd)
    wk = params["attn"]["k"]["kernel"].reshape(d, heads, hd)
    bk = params["attn"]["k"]["bias"].reshape(heads, hd)
    wv = params["attn"]["v"]["kernel"].reshape(d, heads, hd)
    bv = params["attn"]["v"]["bias"].reshape(heads, hd)
    scale = 1.0 / (hd ** 0.5)
    lids = bdg.local_ids.long()

    if use_pallas:
        L_tab = gather_src[lids].contiguous()                      # [nB, T, D]
        u_hm = torch.einsum("nhf,dhf->hnd", q, wk).reshape(heads, nb, b, d)
        sb_hm = torch.einsum("nhf,hf->hn", q, bk).reshape(heads, nb, b)
        mixed_hm = block_dense_attention(
            L_tab, u_hm.to(cdt).contiguous(), sb_hm.contiguous(), _f32(bdg.wdense),
            _f32(bdg.log_mult), scale=scale)                       # [H+1, nB, B, D]
        tv = mixed_hm[:heads].reshape(heads, -1, d)
        weighted = mixed_hm[heads].reshape(-1, d)
        o = torch.einsum("hnd,dhf->nhf", tv, wv)
    else:
        u_blk = torch.einsum("nhf,dhf->nhd", q, wk).reshape(nb, b, heads, d).to(cdt)
        sb_blk = torch.einsum("nhf,hf->nh", q, bk).reshape(nb, b, heads)
        mixed = torch.empty((nb, b, heads + 1, d), dtype=torch.float32, device=msg.device)
        for k in range(nb):
            L = gather_src[lids[k]].float()                        # [T, D]
            wd = bdg.wdense[k]
            scores = (torch.einsum("bhd,td->bht", u_blk[k].float(), L) * scale
                      + sb_blk[k][..., None])
            if bdg.log_mult is not None:                           # duplicate slots
                scores = scores + bdg.log_mult[k][:, None, :]
            attn = masked_softmax(scores, (wd > 0)[:, None, :])   # [B, H, T]
            allw = torch.cat([attn.to(cdt), wd.to(cdt)[:, None, :]], dim=1)
            mixed[k] = torch.einsum("bht,td->bhd", allw.float(), L)
        mixed = mixed.reshape(-1, heads + 1, d)
        tv, weighted = mixed[:, :heads, :], mixed[:, heads, :]
        o = torch.einsum("nhd,dhf->nhf", tv, wv)
    has_any = (bdg.degrees.reshape(-1) > 0).to(o.dtype)
    o = o + has_any[:, None, None] * bv
    attn_out = linear_apply(params["attn"]["out"], o.reshape(-1, d))
    aggregated = linear_apply(params["w_agg"], attn_out + weighted)
    updated = gru_apply(params["gru"], aggregated, msg)
    dropped = updated * (1.0 - cfg.dropout)
    out = layer_norm_apply(params["norm"], dropped, cfg.eps)
    isolated = layer_norm_apply(params["norm"], msg, cfg.eps)
    return torch.where((bdg.degrees.reshape(-1) > 0)[:, None], out, isolated)


def fold_layer_params(params: dict, cfg: RuvectorLayerConfig) -> dict:
    """Fold the layer's attention and epilogue parameters for the fused
    kernel. Exact algebra on [D, D]-class matrices:
      u_h(i)   = msg_i A_h + c_h,  A_h = Wq_h Wk_h^T / sqrt(hd), c_h = bq_h Wk_h^T / sqrt(hd)
      attn_out = sum_h tv_h Wvo_h + 1[deg>0] bvo + bout,  Wvo_h = Wv_h Wout_h
    The <q_h(i), b_k_h> score bias is constant along a softmax row and
    cancels, so the fused kernel never computes it."""
    d = cfg.hidden_dim
    heads = cfg.heads
    hd = d // heads
    wq = params["attn"]["q"]["kernel"].reshape(d, heads, hd)
    bq = params["attn"]["q"]["bias"].reshape(heads, hd)
    wk = params["attn"]["k"]["kernel"].reshape(d, heads, hd)
    wv = params["attn"]["v"]["kernel"].reshape(d, heads, hd)
    bv = params["attn"]["v"]["bias"].reshape(heads, hd)
    wout = params["attn"]["out"]["kernel"]
    bout = params["attn"]["out"]["bias"]
    gru = params["gru"]
    scale = 1.0 / (hd ** 0.5)
    folded = dict(
        A=torch.einsum("dhf,ehf->hde", wq, wk) * scale,
        c=torch.einsum("hf,ehf->he", bq, wk)[:, None, :] * scale,
        Wvo=torch.einsum("dhf,hfe->hde", wv, wout.reshape(heads, hd, d)),
        bvo=(bv.reshape(-1) @ wout)[None, :],
        bout=bout[None, :],
        Wagg=params["w_agg"]["kernel"],
        bagg=params["w_agg"]["bias"][None, :],
        w3=torch.cat([gru["w_z"]["kernel"], gru["w_r"]["kernel"],
                      gru["w_h"]["kernel"]], dim=1),
        b3=torch.cat([gru["w_z"]["bias"], gru["w_r"]["bias"],
                      gru["w_h"]["bias"]])[None, :],
        u2=torch.cat([gru["u_z"]["kernel"], gru["u_r"]["kernel"]], dim=1),
        ub2=torch.cat([gru["u_z"]["bias"], gru["u_r"]["bias"]])[None, :],
        uhk=gru["u_h"]["kernel"],
        uhb=gru["u_h"]["bias"][None, :],
        gamma=params["norm"]["gamma"][None, :],
        beta=params["norm"]["beta"][None, :],
    )
    return {k: v.float().contiguous() for k, v in folded.items()}


def fused_layer_inputs(params: dict, cfg: RuvectorLayerConfig, features: torch.Tensor,
                       bdg: BlockDenseGraph, io_dtype: torch.dtype | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's (local tables [nB, T, D] in the compute dtype, message rows
    [nB, B, D]) for ruvector_layer_apply_block_dense_fused.

    io_dtype=torch.bfloat16 computes the projection in bf16 and keeps msg
    in bf16. When the layout has no halo (table == block) the local tables
    are the message rows themselves, with no gather (the same tensor where
    msg is already in the compute dtype).
    """
    nb, b, t = bdg.n_blocks, bdg.block, bdg.table
    d = cfg.hidden_dim
    cdt = cfg.cdt
    if io_dtype is not None:
        msg = (torch.matmul(features.to(io_dtype).float(),
                            params["w_msg"]["kernel"].to(io_dtype).float()).to(io_dtype)
               + params["w_msg"]["bias"].to(io_dtype))
    else:
        msg = linear_apply(params["w_msg"], features)
    msgf = msg.reshape(nb, b, d)
    if t == b:
        L_tab = msgf.to(cdt)
    else:
        halo = msg.to(cdt)[bdg.local_ids[:, b:].long()]            # [nB, T-B, D]
        L_tab = torch.cat([msgf.to(cdt), halo], dim=1)
    return L_tab.contiguous(), msgf.contiguous()


def ruvector_layer_apply_block_dense_fused(params: dict, cfg: RuvectorLayerConfig,
                                           features: torch.Tensor, bdg: BlockDenseGraph,
                                           io_dtype: torch.dtype | None = None
                                           ) -> torch.Tensor:
    """Whole layer as the msg projection plus ONE fused kernel (K1).

    io_dtype=torch.bfloat16 computes the projection in bf16 and stores msg
    and the output in bf16; the in-kernel GRU/LayerNorm math stays f32
    (fused_layer_inputs).
    """
    L_tab, msgf = fused_layer_inputs(params, cfg, features, bdg, io_dtype)
    out = block_dense_layer_fused(
        L_tab, msgf, _f32(bdg.wdense), fold_layer_params(params, cfg), _f32(bdg.log_mult),
        dropout=cfg.dropout, eps=cfg.eps)
    return out.reshape(-1, cfg.hidden_dim)
