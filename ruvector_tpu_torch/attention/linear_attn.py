"""Linear attention through kernel feature maps, Performer-style (port of
ruvector_tpu/attention/linear_attn.py): the FAVOR+ softmax approximation
and ReLU/ELU kernels, O(S * F * D), out = phi(q) (phi(k)^T v) /
(phi(q) phi(k)^T 1).
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.nn.core import make_generator


@dataclasses.dataclass(frozen=True)
class LinearAttentionConfig:
    dim: int
    num_features: int = 64
    kernel: str = "softmax"  # softmax | relu | elu


def linear_attention_init(seed, cfg: LinearAttentionConfig, device=None) -> dict:
    """Random Gaussian projection [F, D] scaled by 1/sqrt(D)."""
    dev = resolve_device(device)
    proj = torch.randn((cfg.num_features, cfg.dim), generator=make_generator(seed))
    return {"proj": (proj / cfg.dim ** 0.5).to(dev)}


def _feature_map(x: torch.Tensor, proj: torch.Tensor, kernel: str) -> torch.Tensor:
    """phi(x): [..., D] -> [..., F]."""
    p = torch.einsum("...d,fd->...f", x, proj)
    if kernel == "softmax":
        # FAVOR+: exp(proj - ||x||^2 / 2) / sqrt(F)
        norm_sq = torch.sum(x * x, dim=-1, keepdim=True)
        return torch.exp(p - norm_sq / 2.0) / proj.shape[0] ** 0.5
    if kernel == "relu":
        return torch.relu(p)
    if kernel == "elu":
        return torch.where(p >= 0, p, torch.exp(p) - 1.0)
    raise ValueError(f"unknown kernel {kernel}")


def linear_attention_apply(params: dict, cfg: LinearAttentionConfig, q: torch.Tensor,
                           k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, D], k [B, S, D], v [B, S, Dv], mask [B, S] -> [B, Dv]."""
    proj = params["proj"]
    phi_q = _feature_map(q, proj, cfg.kernel)            # [B, F]
    phi_k = _feature_map(k, proj, cfg.kernel)            # [B, S, F]
    if mask is not None:
        phi_k = phi_k * (mask[..., None] > 0)
    kv = torch.einsum("bsf,bsd->bfd", phi_k, v)          # [B, F, Dv]
    normalizer = torch.einsum("bf,bsf->b", phi_q, phi_k)
    out = torch.einsum("bf,bfd->bd", phi_q, kv)
    return out / torch.clamp(normalizer, min=1e-8)[:, None]


register_attention(
    AttentionMechanism(
        name="linear",
        init=linear_attention_init,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            linear_attention_apply(params, cfg, q, k, v, mask),
        default_config=LinearAttentionConfig(dim=64)))
