"""Variational information-bottleneck attention (port of
ruvector_tpu/attention/info_bottleneck.py): a diagonal-Gaussian encoder
over the attention context, its KL to N(0, I) as the rate term, and a
decoder from the bottleneck back to the model width.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.attention.scaled_dot import scaled_dot_attention
from ruvector_tpu_torch.nn.core import linear_apply, linear_init, make_generator


@dataclasses.dataclass(frozen=True)
class IBConfig:
    dim: int = 256
    bottleneck_dim: int = 64
    beta: float = 1e-3        # rate weight


def kl_diagonal_gaussian(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, diag(exp(logvar))) || N(0, I)) summed over the last axis."""
    return 0.5 * torch.sum(torch.exp(logvar) + mu * mu - 1.0 - logvar, dim=-1)


def ib_init(seed, cfg: IBConfig, device=None) -> dict:
    g = make_generator(seed)
    return {"mu": linear_init(g, cfg.dim, cfg.bottleneck_dim, device),
            "logvar": linear_init(g, cfg.dim, cfg.bottleneck_dim, device),
            "decode": linear_init(g, cfg.bottleneck_dim, cfg.dim, device)}


def ib_attention(params: dict, cfg: IBConfig, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, mask: torch.Tensor | None = None,
                 rng: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention -> stochastic bottleneck -> decode. Returns (out, beta *
    rate). With rng None the mean is decoded (inference); with a
    generator (on q's device) z = mu + exp(logvar / 2) * N(0, 1), the
    reparameterised sample that training differentiates through."""
    ctx = scaled_dot_attention(q, k, v, mask)
    mu = linear_apply(params["mu"], ctx)
    logvar = torch.clamp(linear_apply(params["logvar"], ctx), -10.0, 10.0)
    if rng is not None:
        noise = torch.randn(mu.shape, generator=rng, dtype=mu.dtype, device=mu.device)
        z = mu + torch.exp(0.5 * logvar) * noise
    else:
        z = mu
    out = linear_apply(params["decode"], z)
    rate = torch.mean(kl_diagonal_gaussian(mu, logvar))
    return out, cfg.beta * rate


register_attention(
    AttentionMechanism(
        name="info_bottleneck",
        init=ib_init,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            ib_attention(params, cfg or IBConfig(), q, k, v, mask, **kw)[0],
        default_config=IBConfig()))
