"""Topology-aware coherence-gated attention (port of
ruvector_tpu/attention/topology.py).

Attention gated by the coherence of the key set: the Fiedler value (lambda_2
of the normalised Laplacian of the keys' affinity graph), estimated by a
fixed number of deflated power-iteration steps. A coherent set (lambda_2
at or above the threshold) is attended densely; a fragmented one only
through the keys whose cosine affinity with the query passes a cut.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.attention.pde import graph_laplacian
from ruvector_tpu_torch.ops.segment import masked_softmax


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    dim: int = 64
    coherence_threshold: float = 0.2   # lambda_2 below this = fragmented
    affinity_threshold: float = 0.5    # component membership cut
    temperature: float = 1.0
    power_iters: int = 16


def _normalize_rows(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-8)


def fiedler_value(lap: torch.Tensor, iters: int = 16) -> torch.Tensor:
    """lambda_2 per batch row of lap [B, S, S]: power iteration on 2I - L,
    deflated against the constant vector; lambda_2(L) = 2 - lambda_max.

    The iteration starts from sin(1..S), as the JAX scan does, and runs its
    fixed `iters` steps on the device (no host sync)."""
    b, s, _ = lap.shape
    shifted = 2.0 * torch.eye(s, dtype=lap.dtype, device=lap.device)[None] - lap
    ones = torch.ones((b, s), dtype=lap.dtype, device=lap.device) / (s ** 0.5)

    def deflate(w):
        return w - torch.sum(w * ones, dim=1, keepdim=True) * ones

    start = torch.sin(torch.arange(1, s + 1, dtype=torch.float32, device=lap.device))
    v = _normalize_rows(deflate(torch.broadcast_to(start[None], (b, s))))
    for _ in range(iters):
        v = _normalize_rows(deflate(torch.einsum("bst,bt->bs", shifted, v)))
    lam_max = torch.einsum("bs,bst,bt->b", v, shifted, v)
    return 2.0 - lam_max


def coherence_gated_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mask: torch.Tensor | None = None,
                              cfg: TopologyConfig = TopologyConfig()
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B, D], k [B, S, D], v [B, S, Dv], mask [B, S] -> (output [B, Dv],
    lambda_2 [B]).

    Coherent key sets get full attention; fragmented sets only the keys
    whose affinity with the query exceeds the component threshold (all of
    the mask again where that leaves a row empty).
    """
    b, s, d = k.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=q.dtype, device=q.device)
    lap = graph_laplacian(k, mask, normalized=True)
    lam2 = fiedler_value(lap, cfg.power_iters)
    kn = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True), min=1e-8)
    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-8)
    affinity = torch.einsum("bd,bsd->bs", qn, kn)

    fragmented = (lam2 < cfg.coherence_threshold)[:, None]
    component = torch.where(fragmented, (affinity > cfg.affinity_threshold).to(mask.dtype),
                            torch.ones_like(affinity, dtype=mask.dtype))
    eff_mask = mask * component
    empty = torch.sum(eff_mask, dim=1, keepdim=True) == 0
    eff_mask = torch.where(empty, mask, eff_mask)

    scores = torch.einsum("bd,bsd->bs", q, k) / (d ** 0.5) / cfg.temperature
    attn = masked_softmax(scores, eff_mask, dim=-1)
    return torch.einsum("bs,bsd->bd", attn, v), lam2


register_attention(
    AttentionMechanism(
        name="coherence_gated",
        init=None,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            coherence_gated_attention(q, k, v, mask, cfg or TopologyConfig())[0],
        default_config=TopologyConfig()))
