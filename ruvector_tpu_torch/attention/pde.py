"""Diffusion (PDE) attention: heat-equation smoothing on the key graph
(port of ruvector_tpu/attention/pde.py).

The Laplacian L is built per set from the keys' clamped cosine
similarities; the values evolve by explicit Euler, x <- x - dt L x, for
`num_steps` steps before a scaled-dot read by the query.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.ops.segment import masked_softmax


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    dim: int = 256
    dt: float = 0.1
    num_steps: int = 4
    normalized: bool = True
    temperature: float = 1.0


def graph_laplacian(k: torch.Tensor, mask: torch.Tensor,
                    normalized: bool = True) -> torch.Tensor:
    """k [B, S, D], mask [B, S] -> [B, S, S]: L = D - W, or the symmetric
    normalised I - D^-1/2 W D^-1/2 (identity rows only where d > 1e-8)."""
    kn = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True), min=1e-8)
    w = torch.clamp(torch.einsum("bsd,btd->bst", kn, kn), min=0.0)
    w = w * (mask[:, :, None] * mask[:, None, :])
    d = torch.sum(w, dim=-1)
    eye = torch.eye(k.shape[1], dtype=k.dtype, device=k.device)
    if normalized:
        dinv = torch.where(d > 1e-8, torch.rsqrt(torch.clamp(d, min=1e-8)),
                           torch.zeros_like(d))
        return eye * (d > 1e-8)[:, :, None] - dinv[:, :, None] * w * dinv[:, None, :]
    return eye[None] * d[:, :, None] - w


def diffusion_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """Diffuse the values along the key graph, then scaled-dot attention:
    q [B, D], k [B, S, D], v [B, S, Dv], mask [B, S] -> [B, Dv]."""
    b, s, d = k.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=q.dtype, device=q.device)
    lap = graph_laplacian(k, mask, cfg.normalized)
    v_smooth = v
    for _ in range(cfg.num_steps):
        v_smooth = v_smooth - cfg.dt * torch.einsum("bst,btd->bsd", lap, v_smooth)
    scores = torch.einsum("bd,bsd->bs", q, k) / (d ** 0.5) / cfg.temperature
    return torch.einsum("bs,bsd->bd", masked_softmax(scores, mask, dim=-1), v_smooth)


register_attention(
    AttentionMechanism(
        name="diffusion",
        init=None,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            diffusion_attention(q, k, v, mask, cfg or DiffusionConfig()),
        default_config=DiffusionConfig()))
