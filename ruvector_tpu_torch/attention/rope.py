"""Graph rotary position embeddings (port of ruvector_tpu/attention/rope.py).

RoPE where the position is a graph distance (hop count) instead of a
sequence index: inv_freq_i = base^(-2i/dim), and scores of rotated (q, k)
depend on the relative distance. `rope_tables` also gives the
context-extension scalings of the gated transformer: linear, NTK-aware
and YaRN.
"""

from __future__ import annotations

import math

import torch

from ruvector_tpu_torch.device import resolve_device


def rope_tables(dim: int, max_position: int, base: float = 10000.0, scaling: str = "none",
                scaling_factor: float = 1.0, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [max_position, dim/2] float32 on `device`.

    scaling:
      none   — vanilla RoPE
      linear — positions divided by scaling_factor
      ntk    — base multiplied by scaling_factor^(dim/(dim-2)) (NTK-aware)
      yarn   — NTK-by-parts ramp between the high and low frequency bands
    """
    dev = resolve_device(device)
    half = dim // 2
    i = torch.arange(half, dtype=torch.float32, device=dev)
    if scaling == "ntk" and scaling_factor != 1.0:
        base = base * scaling_factor ** (dim / max(dim - 2, 1))
    inv_freq = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32, device=dev),
                               2.0 * i / dim)

    pos = torch.arange(max_position, dtype=torch.float32, device=dev)
    if scaling == "linear" and scaling_factor != 1.0:
        pos = pos / scaling_factor
    if scaling == "yarn" and scaling_factor != 1.0:
        # NTK-by-parts: interpolate only the low-frequency bands
        lo, hi = 1.0, 32.0
        wavelen = 2.0 * math.pi / inv_freq
        ramp = torch.clamp((wavelen - lo) / (hi - lo), 0.0, 1.0)
        inv_freq = inv_freq / scaling_factor * ramp + inv_freq * (1.0 - ramp)

    angles = pos[:, None] * inv_freq[None, :]           # [P, half]
    return torch.cos(angles), torch.sin(angles)


def rope_rotate(x: torch.Tensor, positions: torch.Tensor, cos_table: torch.Tensor,
                sin_table: torch.Tensor) -> torch.Tensor:
    """Rotate the feature pairs (x_2i, x_2i+1) of x [..., dim] by the angle
    of each integer position [...]."""
    cos = cos_table[positions.long()]                   # [..., half]
    sin = sin_table[positions.long()]
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


def graph_rope_encode(q: torch.Tensor, k: torch.Tensor, hop_distance: torch.Tensor,
                      cos_table: torch.Tensor,
                      sin_table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B, D] at distance 0, k [B, S, D] at their hop distances [B, S]."""
    zero = torch.zeros(q.shape[:-1], dtype=torch.long, device=q.device)
    return (rope_rotate(q, zero, cos_table, sin_table),
            rope_rotate(k, hop_distance, cos_table, sin_table))
