"""Mixture-of-experts attention (port of ruvector_tpu/attention/moe.py;
reference ruvector-attention src/moe/).

A learned router over the expert types (scaled dot, linear kernel,
hyperbolic), a top-k gate softmaxed over the kept router logits, and the
gate-weighted mixture of the experts' outputs. Every expert runs on the
whole batch: dense compute with sparse weights, differentiable throughout.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.attention.hyperbolic import hyperbolic_attention
from ruvector_tpu_torch.attention.linear_attn import (
    LinearAttentionConfig,
    linear_attention_apply,
    linear_attention_init,
)
from ruvector_tpu_torch.attention.scaled_dot import scaled_dot_attention
from ruvector_tpu_torch.nn.core import linear_apply, linear_init, make_generator

EXPERT_TYPES = ("standard", "linear", "hyperbolic")


@dataclasses.dataclass(frozen=True)
class MoEAttentionConfig:
    dim: int = 256
    num_experts: int = 3          # one per expert type by default
    top_k: int = 2
    num_features: int = 64        # for the linear expert
    jitter_noise: float = 0.0


def moe_attention_init(seed, cfg: MoEAttentionConfig, device=None) -> dict:
    g = make_generator(seed)
    return {"router": linear_init(g, cfg.dim, cfg.num_experts, device),
            "linear_expert": linear_attention_init(
                g, LinearAttentionConfig(cfg.dim, cfg.num_features), device)}


def moe_attention_apply(params: dict, cfg: MoEAttentionConfig, q: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None = None,
                        rng: torch.Generator | None = None) -> torch.Tensor:
    """q [B, D], k [B, S, D], v [B, S, D], mask [B, S] -> [B, D].

    With jitter_noise > 0 and a generator `rng`, N(0, 1) noise times the
    jitter joins the router logits; the draw is on the generator's device
    and reproducible from its seed (JAX draws from a key instead).
    """
    logits = linear_apply(params["router"], q)                      # [B, E]
    if cfg.jitter_noise > 0 and rng is not None:
        noise = torch.randn(logits.shape, generator=rng, device=rng.device)
        logits = logits + cfg.jitter_noise * noise.to(logits.device)

    # top-k gate over the k largest router logits. Ties: the k-th largest
    # by sort, kept with >=, keeps every logit tied with it, as JAX does
    # (torch.topk would keep exactly k)
    top_k = min(cfg.top_k, cfg.num_experts)
    kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
    gate_logits = torch.where(logits >= kth, logits, torch.full_like(logits, -torch.inf))
    gates = torch.softmax(gate_logits, dim=-1)                      # [B, E]

    outs = []
    for e in range(cfg.num_experts):
        kind = EXPERT_TYPES[e % len(EXPERT_TYPES)]
        if kind == "standard":
            outs.append(scaled_dot_attention(q, k, v, mask))
        elif kind == "linear":
            outs.append(linear_attention_apply(
                params["linear_expert"], LinearAttentionConfig(cfg.dim, cfg.num_features),
                q, k, v, mask))
        else:
            outs.append(hyperbolic_attention(q, k, v, mask))
    return torch.einsum("be,bed->bd", gates, torch.stack(outs, dim=1))


register_attention(
    AttentionMechanism(
        name="moe",
        init=moe_attention_init,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            moe_attention_apply(params, cfg, q, k, v, mask, **kw),
        default_config=MoEAttentionConfig()))
