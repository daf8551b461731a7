"""Local-global (Longformer-style) attention (port of
ruvector_tpu/attention/local_global.py): each position attends a window
around itself plus the first G global tokens, as one masked attention
over the banded mask.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.ops.segment import masked_softmax


def local_global_mask(seq_len: int, local_window: int, num_global: int,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """[S, S] mask: position i attends j iff |i - j| <= W/2 or j < G."""
    dev = resolve_device(device)
    half = local_window // 2
    i = torch.arange(seq_len, device=dev)
    local = torch.abs(i[:, None] - i[None, :]) <= half
    global_ = (i < num_global)[None, :]
    return (local | global_).to(dtype)


def local_global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           local_window: int = 64, num_global: int = 4,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sequence self-attention form: q, k [S, D], v [S, Dv], mask [S] of
    valid keys -> [S, Dv]."""
    s, d = q.shape
    band = local_global_mask(s, local_window, num_global, q.dtype, q.device)
    if mask is not None:
        band = band * mask[None, :]
    scores = (q @ k.T) * (1.0 / d ** 0.5)
    return masked_softmax(scores, band, dim=-1) @ v


register_attention(
    AttentionMechanism(name="local_global", init=None,
                       apply=lambda params, cfg, q, k, v, mask=None, **kw:
                       local_global_attention(q, k, v, mask=mask, **kw)))
