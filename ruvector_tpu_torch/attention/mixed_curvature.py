"""Mixed-curvature and Lorentz-model attention (port of
ruvector_tpu/attention/mixed_curvature.py).

Product-manifold attention over Euclidean x hyperbolic x spherical
factors of the feature vector, each with its own curvature; and a Lorentz
(hyperboloid) cascade that scores at several curvatures in the Lorentz
model and averages the attention distributions.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.attention.hyperbolic import poincare_distance, project_to_ball
from ruvector_tpu_torch.ops.segment import masked_softmax


@dataclasses.dataclass(frozen=True)
class MixedCurvatureConfig:
    dim: int = 96                 # split evenly across the three factors
    curvature_hyp: float = 1.0    # negative curvature magnitude
    curvature_sph: float = 1.0    # positive curvature magnitude
    temperature: float = 1.0

    @property
    def factor_dim(self) -> int:
        return self.dim // 3


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)


def spherical_distance(u: torch.Tensor, v: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """Great-circle distance on the radius-1/sqrt(c) sphere (projected)."""
    cos = torch.clamp(torch.sum(_unit(u) * _unit(v), dim=-1), -1.0, 1.0)
    return torch.arccos(cos) / (c ** 0.5)


def mixed_curvature_distance(q: torch.Tensor, k: torch.Tensor,
                             cfg: MixedCurvatureConfig) -> torch.Tensor:
    """d^2 = d_E^2 + d_H^2 + d_S^2 over the three factor subspaces."""
    f = cfg.factor_dim
    qe, qh, qs = q[..., :f], q[..., f:2 * f], q[..., 2 * f:3 * f]
    ke, kh, ks = k[..., :f], k[..., f:2 * f], k[..., 2 * f:3 * f]
    de = torch.linalg.vector_norm(qe - ke, dim=-1)
    dh = poincare_distance(project_to_ball(qh, cfg.curvature_hyp),
                           project_to_ball(kh, cfg.curvature_hyp), cfg.curvature_hyp)
    ds = spherical_distance(qs, ks, cfg.curvature_sph)
    return torch.sqrt(de ** 2 + dh ** 2 + ds ** 2 + 1e-12)


def mixed_curvature_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mask: torch.Tensor | None = None,
                              cfg: MixedCurvatureConfig = MixedCurvatureConfig()
                              ) -> torch.Tensor:
    """q [B, D], k [B, S, D], v [B, S, Dv], mask [B, S] -> [B, Dv]."""
    b, s, _ = k.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=q.dtype, device=q.device)
    dist = mixed_curvature_distance(q[:, None, :], k, cfg)
    attn = masked_softmax(-dist / cfg.temperature, mask, dim=-1)
    return torch.einsum("bs,bsd->bd", attn, v)


# --- Lorentz (hyperboloid) model --------------------------------------------

def to_lorentz(x: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """Lift Poincaré-ball points to the hyperboloid: prepends the time
    coordinate x0 = sqrt(1/c + ||x||^2)."""
    x0 = torch.sqrt(1.0 / c + torch.sum(x * x, dim=-1, keepdim=True))
    return torch.cat([x0, x], dim=-1)


def lorentz_inner(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Minkowski inner product <u, v>_L = -u0 v0 + sum_i ui vi."""
    return -u[..., 0] * v[..., 0] + torch.sum(u[..., 1:] * v[..., 1:], dim=-1)


def lorentz_distance(u: torch.Tensor, v: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """d(u, v) = acosh(-c <u, v>_L) / sqrt(c), stable far from the origin."""
    arg = torch.clamp(-c * lorentz_inner(u, v), min=1.0 + 1e-7)
    return torch.acosh(arg) / (c ** 0.5)


def lorentz_cascade_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mask: torch.Tensor | None = None,
                              curvatures: tuple = (0.5, 1.0, 2.0),
                              temperature: float = 1.0) -> torch.Tensor:
    """Cascade over curvatures: score each key in the Lorentz model at each
    curvature and average the attention distributions (a multi-scale
    hierarchy reader). q [B, D], k [B, S, D], v [B, S, Dv] -> [B, Dv]."""
    b, s, _ = k.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=q.dtype, device=q.device)
    attn_sum = torch.zeros((b, s), dtype=torch.float32, device=q.device)
    for c in curvatures:
        ql = to_lorentz(project_to_ball(q, c), c)
        kl = to_lorentz(project_to_ball(k, c), c)
        dist = lorentz_distance(ql[:, None, :], kl, c)
        attn_sum = attn_sum + masked_softmax(-dist / temperature, mask, dim=-1)
    # the mean of distributions already sums to 1 on rows with a key
    attn = attn_sum / len(curvatures)
    return torch.einsum("bs,bsd->bd", attn, v)


register_attention(
    AttentionMechanism(
        name="mixed_curvature",
        init=None,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            mixed_curvature_attention(q, k, v, mask, cfg or MixedCurvatureConfig()),
        default_config=MixedCurvatureConfig()))

register_attention(
    AttentionMechanism(
        name="lorentz_cascade",
        init=None,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            lorentz_cascade_attention(q, k, v, mask, **kw)))
