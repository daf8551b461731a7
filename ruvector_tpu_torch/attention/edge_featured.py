"""Edge-featured graph attention, GATv2-style (port of
ruvector_tpu/attention/edge_featured.py).

Per head the score a_src·(W h_i) + a_dst·(W h_j) + a_edge·(W_e e_ij)
goes through a LeakyReLU, a masked softmax over the neighbors, and weights
the transformed values; heads are concatenated or averaged. Batched over
all nodes: the per-head transforms are one product each.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.nn.core import make_generator, xavier_normal
from ruvector_tpu_torch.ops.segment import masked_softmax


@dataclasses.dataclass(frozen=True)
class EdgeFeaturedConfig:
    node_dim: int = 256
    edge_dim: int = 64
    num_heads: int = 4
    concat_heads: bool = True
    negative_slope: float = 0.2

    @property
    def head_dim(self) -> int:
        return self.node_dim // self.num_heads


def edge_featured_init(seed, cfg: EdgeFeaturedConfig, device=None) -> dict:
    """W_node [H, node_dim, hd] and W_edge [H, edge_dim, hd] Xavier-normal,
    the attention vectors [H, hd] normal scaled by 1/sqrt(hd)."""
    dev = resolve_device(device)
    g = make_generator(seed)
    hd, h = cfg.head_dim, cfg.num_heads
    attn_scale = (1.0 / hd) ** 0.5
    return {
        "w_node": torch.stack([xavier_normal(g, cfg.node_dim, hd, dev) for _ in range(h)]),
        "w_edge": torch.stack([xavier_normal(g, cfg.edge_dim, hd, dev) for _ in range(h)]),
        **{name: (attn_scale * torch.randn((h, hd), generator=g)).to(dev)
           for name in ("a_src", "a_dst", "a_edge")},
    }


def edge_featured_apply(params: dict, cfg: EdgeFeaturedConfig, q: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None = None,
                        edges: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, node_dim], k and v [B, S, node_dim], mask [B, S], edges
    [B, S, edge_dim] (zeros when None) -> [B, H*hd] (concat) or [B, hd]."""
    b, s, _ = k.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=q.dtype, device=q.device)
    if edges is None:
        edges = torch.zeros((b, s, cfg.edge_dim), dtype=q.dtype, device=q.device)
    w_node = params["w_node"]
    qh = torch.einsum("bd,hdf->bhf", q, w_node)            # [B, H, hd]
    kh = torch.einsum("bsd,hdf->bshf", k, w_node)          # [B, S, H, hd]
    vh = kh if v is k else torch.einsum("bsd,hdf->bshf", v, w_node)
    eh = torch.einsum("bse,hef->bshf", edges, params["w_edge"])

    score = (torch.einsum("bhf,hf->bh", qh, params["a_src"])[:, None, :]
             + torch.einsum("bshf,hf->bsh", kh, params["a_dst"])
             + torch.einsum("bshf,hf->bsh", eh, params["a_edge"]))   # [B, S, H]
    score = torch.nn.functional.leaky_relu(score, cfg.negative_slope)

    attn = masked_softmax(score, mask[:, :, None], dim=1)  # softmax over S
    out = torch.einsum("bsh,bshf->bhf", attn, vh)          # [B, H, hd]
    if cfg.concat_heads:
        return out.reshape(b, cfg.num_heads * cfg.head_dim)
    return torch.mean(out, dim=1)


register_attention(
    AttentionMechanism(
        name="edge_featured",
        init=edge_featured_init,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            edge_featured_apply(params, cfg, q, k, v, mask, **kw),
        default_config=EdgeFeaturedConfig()))
