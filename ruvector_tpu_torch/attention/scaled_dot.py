"""Scaled dot-product attention, parameter-free and batched (port of
ruvector_tpu/attention/scaled_dot.py). One batched product gives every
query's scores; the epsilon-guarded masked softmax keeps the reference's
`sum_exp.max(1e-10)` convention."""

from __future__ import annotations

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.ops.segment import masked_softmax


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor | None = None,
                         temperature: float = 1.0) -> torch.Tensor:
    """q [B, D], k [B, S, D], v [B, S, Dv], mask [B, S] ->
    out[b] = softmax(<q[b], k[b, s]> / (sqrt(D) * temperature)) @ v[b]."""
    d = q.shape[-1]
    if mask is None:
        mask = torch.ones(k.shape[:-1], dtype=q.dtype, device=q.device)
    scale = 1.0 / (torch.sqrt(torch.tensor(d, dtype=q.dtype, device=q.device)) * temperature)
    scores = torch.einsum("bd,bsd->bs", q, k) * scale
    attn = masked_softmax(scores, mask, dim=-1)
    return torch.einsum("bs,bsd->bd", attn, v)


register_attention(
    AttentionMechanism(name="scaled_dot", init=None,
                       apply=lambda params, cfg, q, k, v, mask=None, **kw:
                       scaled_dot_attention(q, k, v, mask, **kw)))
