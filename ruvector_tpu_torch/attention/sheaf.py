"""Sheaf attention, the coherence-gated transformer's attention (port of
ruvector_tpu/attention/sheaf.py).

Restriction maps rho replace learned Q/K projections; the residual of a
pair is rho_q(x_i) - rho_k(x_j) and its energy E_ij = ||r_ij||^2, taken
for all pairs as one product through ||a - b||^2 = |a|^2 + |b|^2 - 2ab.
Attention is softmax_j(-beta E_ij), optionally over the pairs below an
energy quantile; tokens route to compute lanes by energy, and layers
stop early once the total energy settles.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ruvector_tpu_torch.attention.base import AttentionMechanism, register_attention
from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.nn.core import make_generator, xavier_normal
from ruvector_tpu_torch.ops.segment import masked_softmax


@dataclasses.dataclass(frozen=True)
class SheafAttentionConfig:
    dim: int = 64
    restriction_dim: int = 64
    beta: float = 1.0                        # energy -> attention sharpness
    residual_sparse_threshold: float = 0.0   # 0 = dense
    exit_energy_tol: float = 1e-3


def quantile(x: torch.Tensor, q: float, dim: int | None = None,
             keepdim: bool = False) -> torch.Tensor:
    """jnp.quantile's default ('linear') method: sort, then interpolate
    between the two order statistics around q (n - 1), the position taken
    in x's dtype as JAX does. Over the flattened tensor when dim is None.
    torch.quantile refuses inputs of more than 2^24 elements; this does
    not."""
    if dim is None:
        out = quantile(x.reshape(-1), q, 0)
        return out.reshape([1] * x.ndim) if keepdim else out
    v = torch.sort(x, dim=dim).values
    n = v.shape[dim]
    pos = torch.tensor(q, dtype=x.dtype) * (torch.tensor(n, dtype=x.dtype) - 1)
    lo_f, hi_f = torch.floor(pos), torch.ceil(pos)
    hi_w = pos - lo_f
    lo_w = 1 - hi_w
    lo = int(torch.clamp(lo_f, 0, n - 1))
    hi = int(torch.clamp(hi_f, 0, n - 1))
    out = (v.narrow(dim, lo, 1) * lo_w.to(x.device)
           + v.narrow(dim, hi, 1) * hi_w.to(x.device))
    return out if keepdim else out.squeeze(dim)


def restriction_map_init(seed, in_dim: int, out_dim: int, device=None) -> torch.Tensor:
    """Near-orthogonal restriction map: the Q of a random matrix's QR,
    its first out_dim columns."""
    dev = resolve_device(device)
    m = torch.randn((in_dim, max(in_dim, out_dim)), generator=make_generator(seed))
    return torch.linalg.qr(m).Q[:, :out_dim].contiguous().to(dev)


def sheaf_init(seed, cfg: SheafAttentionConfig, device=None) -> dict:
    g = make_generator(seed)
    return {"rho_q": restriction_map_init(g, cfg.dim, cfg.restriction_dim, device),
            "rho_k": restriction_map_init(g, cfg.dim, cfg.restriction_dim, device),
            "rho_v": xavier_normal(g, cfg.dim, cfg.dim, device)}


def edge_energies(params: dict, x: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """E_ij = ||rho_q(x_i) - rho_k(x_j)||^2 for all pairs, [S, S]; +inf
    at masked keys."""
    rq = x @ params["rho_q"]
    rk = x @ params["rho_k"]
    qq = torch.sum(rq * rq, dim=-1, keepdim=True)
    kk = torch.sum(rk * rk, dim=-1)[None, :]
    e = torch.clamp(qq + kk - 2.0 * (rq @ rk.T), min=0.0)
    if mask is not None:
        e = torch.where(mask[None, :] > 0, e, torch.full_like(e, torch.inf))
    return e


def sheaf_attention(params: dict, cfg: SheafAttentionConfig, x: torch.Tensor,
                    mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [S, D] token states, mask [S] -> (output [S, D], token energy [S]).

    Coherent (low-energy) pairs attend strongly. With a positive
    residual_sparse_threshold only the pairs at or below that quantile of
    the energies are attended.
    """
    s = x.shape[0]
    if mask is None:
        mask = torch.ones((s,), dtype=x.dtype, device=x.device)
    e = edge_energies(params, x, mask)                  # [S, S]
    finite = torch.isfinite(e)
    scores = -cfg.beta * torch.where(finite, e, torch.full_like(e, 1e30))

    pair_mask = torch.broadcast_to(mask[None, :], (s, s))
    finite_e = torch.where(finite, e, torch.zeros_like(e))
    if cfg.residual_sparse_threshold > 0:
        thresh = quantile(finite_e, cfg.residual_sparse_threshold)
        pair_mask = pair_mask * (finite_e <= thresh)

    attn = masked_softmax(scores, pair_mask, dim=-1)
    out = attn @ (x @ params["rho_v"])
    token_energy = torch.sum(finite_e * pair_mask, dim=-1) * mask
    return out, token_energy


class ComputeLane(enum.Enum):
    FULL = 0       # high-energy tokens: full compute
    CHEAP = 1      # mid-energy: reduced compute
    SKIP = 2       # coherent tokens: skip


def route_lanes_device(token_energy: torch.Tensor, full_quantile: float = 0.7,
                       skip_quantile: float = 0.3) -> torch.Tensor:
    """Token router on the tensor's device: [..., S] energies -> [..., S]
    int32 lane ids (ComputeLane values), the quantiles per row."""
    e = torch.as_tensor(token_energy)
    hi = quantile(e, full_quantile, dim=-1, keepdim=True)
    lo = quantile(e, skip_quantile, dim=-1, keepdim=True)
    lanes = torch.full(e.shape, ComputeLane.CHEAP.value, dtype=torch.int32, device=e.device)
    lanes = torch.where(e <= lo, torch.full_like(lanes, ComputeLane.SKIP.value), lanes)
    return torch.where(e >= hi, torch.full_like(lanes, ComputeLane.FULL.value), lanes)


def route_tokens_by_energy(token_energy: torch.Tensor, full_quantile: float = 0.7,
                           skip_quantile: float = 0.3) -> list[ComputeLane]:
    """Enum view of route_lanes_device for host-side inspection."""
    ids = route_lanes_device(token_energy, full_quantile, skip_quantile).cpu().numpy()
    by_val = {m.value: m for m in ComputeLane}
    return [by_val[int(v)] for v in np.asarray(ids).reshape(-1)]


def process_with_early_exit(params: dict, cfg: SheafAttentionConfig, x: torch.Tensor,
                            max_layers: int = 8) -> tuple[torch.Tensor, int]:
    """Apply sheaf attention as residual layers until the total energy
    changes by less than exit_energy_tol relative."""
    prev_energy = float("inf")
    layers_run = 0
    for _ in range(max_layers):
        out, energy = sheaf_attention(params, cfg, x)
        x = x + out
        total = float(torch.sum(energy))
        layers_run += 1
        if abs(prev_energy - total) / max(abs(prev_energy), 1e-8) < cfg.exit_energy_tol:
            break
        prev_energy = total
    return x, layers_run


register_attention(
    AttentionMechanism(
        name="sheaf",
        init=sheaf_init,
        apply=lambda params, cfg, q, k, v, mask=None, **kw:
            sheaf_attention(params, cfg or SheafAttentionConfig(), q, mask)[0],
        default_config=SheafAttentionConfig()))
