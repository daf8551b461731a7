"""Dual-space attention: a blend of Euclidean and hyperbolic scores (port
of ruvector_tpu/attention/dual_space.py).

Scores are a weighted blend of the scaled dot product and the negative
Poincaré distance of the ball-projected points, softmaxed over the blend;
the weights (w_e, w_h) are fixed by the config or learned as softmaxed
logits.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.attention.hyperbolic import poincare_distance, project_to_ball
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.ops.segment import masked_softmax


@dataclasses.dataclass(frozen=True)
class DualSpaceConfig:
    dim: int = 256
    curvature: float = 1.0
    euclidean_weight: float = 0.5
    hyperbolic_weight: float = 0.5
    temperature: float = 1.0
    learn_weights: bool = False


def dual_space_init(seed, cfg: DualSpaceConfig, device=None) -> dict:
    """Learnable blend logits (softmaxed at apply); deterministic, so the
    seed is unused."""
    w = [max(cfg.euclidean_weight, 1e-6), max(cfg.hyperbolic_weight, 1e-6)]
    return {"blend": torch.log(torch.tensor(w, dtype=torch.float32)).to(resolve_device(device))}


def dual_space_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor | None = None,
                         cfg: DualSpaceConfig = DualSpaceConfig(),
                         params: dict | None = None) -> torch.Tensor:
    """q [B, D], k [B, S, D], v [B, S, Dv], mask [B, S] -> [B, Dv]."""
    b, s, d = k.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=q.dtype, device=q.device)
    euc = torch.einsum("bd,bsd->bs", q, k) / (d ** 0.5)
    qb = project_to_ball(q, cfg.curvature)
    kb = project_to_ball(k, cfg.curvature)
    hyp = -poincare_distance(qb[:, None, :], kb, cfg.curvature)
    if cfg.learn_weights and params is not None:
        w = torch.softmax(params["blend"], dim=0)
        we, wh = w[0], w[1]
    else:
        total = cfg.euclidean_weight + cfg.hyperbolic_weight
        we = cfg.euclidean_weight / total
        wh = cfg.hyperbolic_weight / total
    scores = (we * euc + wh * hyp) / cfg.temperature
    attn = masked_softmax(scores, mask, dim=-1)
    return torch.einsum("bs,bsd->bd", attn, v)


register_attention(
    AttentionMechanism(
        name="dual_space",
        init=dual_space_init,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            dual_space_attention(q, k, v, mask, cfg or DualSpaceConfig(), params),
        default_config=DualSpaceConfig()))
