"""Optimal-transport attention: sliced-Wasserstein and centroid OT (port
of ruvector_tpu/attention/transport.py).

P random unit directions project every point with one product; the
sliced-Wasserstein distance compares sorted projections. Centroid OT
clusters each key set with a few k-means steps and spreads a softmax
transport plan over the centroids back onto their member keys.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.nn.core import make_generator
from ruvector_tpu_torch.ops.segment import masked_softmax


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    dim: int = 256
    num_projections: int = 16
    num_centroids: int = 8
    temperature: float = 1.0
    seed: int = 42


def transport_init(seed, cfg: TransportConfig, device=None) -> dict:
    """Random projection directions [D, P], unit columns."""
    dev = resolve_device(device)
    proj = torch.randn((cfg.dim, cfg.num_projections), generator=make_generator(seed))
    proj = proj / torch.clamp(torch.linalg.vector_norm(proj, dim=0, keepdim=True), min=1e-8)
    return {"proj": proj.to(dev)}


def sliced_wasserstein_distance(x: torch.Tensor, y: torch.Tensor,
                                proj: torch.Tensor) -> torch.Tensor:
    """SW2 distance between the point sets x [A, D] and y [B, D] through
    sorted 1-d projections; sets of other sizes are aligned by linear
    interpolation of the sorted projections onto a common grid."""
    px = torch.sort(x @ proj, dim=0).values            # [A, P]
    py = torch.sort(y @ proj, dim=0).values            # [B, P]
    n = max(px.shape[0], py.shape[0])
    grid = torch.linspace(0.0, 1.0, n, dtype=px.dtype, device=px.device)

    def resample(sorted_vals):
        a = sorted_vals.shape[0]
        pos = grid * (a - 1)
        lo = torch.floor(pos).long()
        hi = torch.clamp(lo + 1, max=a - 1)
        frac = (pos - lo)[:, None]
        return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac

    return torch.sqrt(torch.mean((resample(px) - resample(py)) ** 2))


def sliced_wasserstein_attention(params: dict, cfg: TransportConfig, q: torch.Tensor,
                                 k: torch.Tensor, v: torch.Tensor,
                                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scores = -SW distance between the query point and each key point
    (for one-point sets SW is the projected L2): q [B, D], k [B, S, D],
    v [B, S, Dv], mask [B, S] -> [B, Dv]."""
    proj = params["proj"]
    b, s, _ = k.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=q.dtype, device=q.device)
    qp = q @ proj                                        # [B, P]
    kp = torch.einsum("bsd,dp->bsp", k, proj)
    sw = torch.sqrt(torch.mean((qp[:, None, :] - kp) ** 2, dim=-1) + 1e-12)
    attn = masked_softmax(-sw / cfg.temperature, mask, dim=-1)
    return torch.einsum("bs,bsd->bd", attn, v)


def centroid_ot_attention(params: dict, cfg: TransportConfig, q: torch.Tensor,
                          k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor | None = None,
                          kmeans_iters: int = 4) -> torch.Tensor:
    """Cluster each key set into C centroids (k-means from its first C
    keys; a key equally near two centroids joins the first), weight the
    centroids by an unmasked softmax of query similarity plus log mass,
    and spread each centroid's weight evenly over its member keys:
    q [B, D], k [B, S, D], v [B, S, Dv], mask [B, S] -> [B, Dv]."""
    b, s, d = k.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=q.dtype, device=q.device)
    c = min(cfg.num_centroids, s)

    cent = k[:, :c, :]
    assign = counts = None
    for _ in range(kmeans_iters):
        d2 = torch.sum((k[:, :, None, :] - cent[:, None, :, :]) ** 2, dim=-1)   # [B, S, C]
        d2 = torch.where(mask[:, :, None] > 0, d2, torch.full_like(d2, torch.inf))
        # argmin: the first of equal minima, as jnp.argmin
        assign = torch.nn.functional.one_hot(torch.argmin(d2, dim=-1), c).to(k.dtype)
        assign = assign * mask[:, :, None]
        counts = torch.clamp(torch.sum(assign, dim=1), min=1e-8)               # [B, C]
        cent = torch.einsum("bsc,bsd->bcd", assign, k) / counts[:, :, None]

    sim = torch.einsum("bd,bcd->bc", q, cent) / (d ** 0.5)
    mass = counts / torch.clamp(torch.sum(counts, dim=1, keepdim=True), min=1e-8)
    plan = torch.softmax(sim / cfg.temperature + torch.log(mass + 1e-12), dim=-1)

    key_w = torch.einsum("bc,bsc->bs", plan / counts, assign) * mask
    key_w = key_w / torch.clamp(torch.sum(key_w, dim=1, keepdim=True), min=1e-10)
    return torch.einsum("bs,bsd->bd", key_w, v)


register_attention(
    AttentionMechanism(
        name="sliced_wasserstein",
        init=transport_init,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            sliced_wasserstein_attention(params, cfg or TransportConfig(), q, k, v, mask),
        default_config=TransportConfig()))

register_attention(
    AttentionMechanism(
        name="centroid_ot",
        init=transport_init,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            centroid_ot_attention(params, cfg or TransportConfig(), q, k, v, mask),
        default_config=TransportConfig()))
