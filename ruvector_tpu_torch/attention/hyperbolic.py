"""Poincaré-ball geometry and hyperbolic attention (port of
ruvector_tpu/attention/hyperbolic.py).

exp_map, log_map, mobius_add, poincare_distance and project_to_ball,
batched over any leading axes and guarded by the reference's EPS = 1e-7
clamps; attention weights keys by their negative Poincaré distance.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.ops.segment import masked_softmax

EPS = 1e-7


def _nsq(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1, keepdim=True)


def project_to_ball(x: torch.Tensor, c: float = 1.0, eps: float = EPS) -> torch.Tensor:
    """Clip into the open ball of curvature -c: ||x|| < (1 - eps)/sqrt(c)."""
    c = abs(c)
    max_norm = (1.0 - eps) / (c ** 0.5)
    norm = torch.sqrt(torch.clamp(_nsq(x), min=EPS * EPS))
    return x * torch.clamp(max_norm / norm, max=1.0)


def poincare_distance(u: torch.Tensor, v: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """d_c(u, v) = acosh(1 + 2c||u-v||^2 / ((1-c||u||^2)(1-c||v||^2))) / sqrt(c)."""
    c = abs(c)
    diff_sq = torch.sum((u - v) ** 2, dim=-1)
    lam_u = 1.0 - c * torch.sum(u * u, dim=-1)
    lam_v = 1.0 - c * torch.sum(v * v, dim=-1)
    arg = 1.0 + 2.0 * c * diff_sq / torch.clamp(lam_u * lam_v, min=EPS)
    return torch.acosh(torch.clamp(arg, min=1.0)) / c ** 0.5


def mobius_add(u: torch.Tensor, v: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """Möbius addition u ⊕_c v, projected into the ball."""
    c = abs(c)
    uu, vv = _nsq(u), _nsq(v)
    uv = torch.sum(u * v, dim=-1, keepdim=True)
    coef_u = 1.0 + 2.0 * c * uv + c * vv
    coef_v = 1.0 - c * uu
    denom = 1.0 + 2.0 * c * uv + c * c * uu * vv
    return project_to_ball((coef_u * u + coef_v * v) / torch.clamp(denom, min=EPS), c)


def mobius_scalar_mult(r: float, v: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """r ⊗_c v = tanh(r atanh(sqrt(c)||v||)) v / (sqrt(c)||v||)."""
    c = abs(c)
    sqrt_c = c ** 0.5
    norm = torch.sqrt(torch.clamp(_nsq(v), min=EPS * EPS))
    arg = torch.clamp(sqrt_c * norm, max=1.0 - EPS)
    scale = torch.tanh(r * torch.atanh(arg)) / (sqrt_c * norm)
    return torch.where(norm > EPS, scale * v, v)


def exp_map(v: torch.Tensor, p: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """Exponential map of the tangent vector v at the point p."""
    c = abs(c)
    sqrt_c = c ** 0.5
    lam_p = 1.0 / torch.clamp(1.0 - c * _nsq(p), min=EPS)
    norm_v = torch.sqrt(torch.clamp(_nsq(v), min=EPS * EPS))
    norm_vp = lam_p * norm_v
    coef = torch.tanh(sqrt_c * norm_vp / 2.0) / (sqrt_c * norm_vp)
    out = mobius_add(p, coef * v, c)
    return torch.where(norm_v > EPS, out, torch.broadcast_to(p, out.shape))


def log_map(y: torch.Tensor, p: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """Logarithmic map of y into the tangent space at p:
    (2 / (sqrt_c lambda_p)) atanh(sqrt_c ||-p ⊕ y||) / ||-p ⊕ y|| (-p ⊕ y),
    lambda_p = 1/(1 - c||p||^2)."""
    c = abs(c)
    sqrt_c = c ** 0.5
    lam_p = 1.0 / torch.clamp(1.0 - c * _nsq(p), min=EPS)
    w = mobius_add(-p, y, c)
    norm_w = torch.sqrt(torch.clamp(_nsq(w), min=EPS * EPS))
    arg = torch.clamp(sqrt_c * norm_w, max=1.0 - EPS)
    coef = (2.0 / (sqrt_c * lam_p)) * torch.atanh(arg) / norm_w
    return torch.where(norm_w > EPS, coef * w, torch.zeros_like(w))


def hyperbolic_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor | None = None, c: float = 1.0,
                         temperature: float = 1.0) -> torch.Tensor:
    """q [B, D] and k [B, S, D] projected into the ball, v [B, S, Dv]
    euclidean: softmax(-d_c(q, k) / temperature) @ v."""
    qp = project_to_ball(q, c)
    kp = project_to_ball(k, c)
    if mask is None:
        mask = torch.ones(k.shape[:-1], dtype=q.dtype, device=q.device)
    dist = poincare_distance(qp[:, None, :], kp, c)     # [B, S]
    attn = masked_softmax(-dist / temperature, mask, dim=-1)
    return torch.einsum("bs,bsd->bd", attn, v)


register_attention(
    AttentionMechanism(name="hyperbolic", init=None,
                       apply=lambda params, cfg, q, k, v, mask=None, **kw:
                       hyperbolic_attention(q, k, v, mask, **kw)))
