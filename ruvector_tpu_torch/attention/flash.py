"""Flash attention: blockwise online softmax over key blocks (port of
ruvector_tpu/attention/flash.py).

The running (max, sum, acc) recurrence of the reference's
sparse/flash.rs:86-140, one key block at a time, so the [B, S] score
matrix never exists whole. Plain PyTorch: the serving re-rank takes it for
pools below ef = 256, and it is the oracle of the K8 kernel
(ops/kernels/flash_neighbor.py), which takes the wide pools on the card.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention

_NEG = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None = None, block_size: int = 128) -> torch.Tensor:
    """q [B, D], k [B, S, D], v [B, S, Dv], mask [B, S] -> out [B, Dv]
    float32. Keys past S in the last block are padding (mask 0)."""
    b, s, d = k.shape
    dv = v.shape[-1]
    if mask is None:
        mask = torch.ones((b, s), dtype=q.dtype, device=q.device)
    nblk = -(-s // block_size)
    pad = nblk * block_size - s
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    m_run = torch.full((b,), _NEG, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b,), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, dv), dtype=torch.float32, device=q.device)
    for j in range(nblk):
        blk = slice(j * block_size, (j + 1) * block_size)
        valid = mask[:, blk] > 0
        scores = torch.einsum("bd,bsd->bs", q, k[:, blk]) * scale
        scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
        m_new = torch.maximum(m_run, torch.amax(scores, dim=-1))
        rescale = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[:, None]) * valid
        l_run = l_run * rescale + torch.sum(p, dim=-1)
        acc = acc * rescale[:, None] + torch.einsum("bs,bsd->bd", p, v[:, blk])
        m_run = m_new
    # the reference's final guard: normalize only when sum_exp > 1e-8 (flash.rs:137)
    denom = torch.where(l_run > 1e-8, l_run, torch.ones_like(l_run))
    return acc / denom[:, None]


register_attention(
    AttentionMechanism(name="flash", init=None,
                       apply=lambda params, cfg, q, k, v, mask=None, **kw:
                       flash_attention(q, k, v, mask, **kw)))
