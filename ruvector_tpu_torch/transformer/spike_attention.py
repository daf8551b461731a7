"""Spike-driven attention — multiplication-free, event-coded (port of
ruvector_tpu/transformer/spike_attention.py).

Reference: ruvector-mincut-gated-transformer/src/attention/spike_driven.rs
(Yao et al. 2023): rate/temporal coding of activations into binary spike
trains, binary QKV, mask-and-add attention (no FP multiplies), refractory
period suppressing bursts.

Spike trains are dense {-1, 0, 1} tensors over a temporal axis [T, S, D];
"mask-and-add" becomes integer sums. The rate coder runs its T steps on
the host (the reference's lax.scan).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SpikeDrivenConfig:
    spike_threshold: float = 0.5       # spike_threshold_q15 / 32768
    temporal_coding_steps: int = 8
    binary_qkv: bool = True
    refractory_period: int = 2


def encode_rate(x: torch.Tensor, cfg: SpikeDrivenConfig) -> torch.Tensor:
    """Rate-code |x| into T binary steps with refractory suppression.

    Returns spikes [T, ..., D] in {-1, 0, +1}: deterministic thresholded
    accumulator coding (an integrate-and-fire neuron unrolled T steps) —
    same scheme as spike_driven.rs rate coding.
    """
    t = cfg.temporal_coding_steps
    # the reference divides by t inside a compiled scan, where XLA folds
    # the division by a constant into a product with float32(1 / t)
    step_in = torch.abs(x) * (1.0 / t)
    sign = torch.sign(x)
    acc = torch.zeros_like(x)
    refr = torch.zeros_like(x, dtype=torch.int32)
    spikes = []
    for _ in range(t):
        acc = acc + step_in
        fire = (acc >= cfg.spike_threshold) & (refr <= 0)
        acc = torch.where(fire, acc - cfg.spike_threshold, acc)
        refr = torch.where(fire, cfg.refractory_period, torch.clamp(refr - 1, min=0))
        spikes.append(fire.to(x.dtype) * sign)
    return torch.stack(spikes)                     # [T, ..., D]


def decode_rate(spikes: torch.Tensor, cfg: SpikeDrivenConfig) -> torch.Tensor:
    """Inverse of rate coding: value ≈ spike_count * threshold."""
    return torch.sum(spikes, dim=0) * cfg.spike_threshold


def spike_driven_attention(
    q: torch.Tensor,          # [S, D]
    k: torch.Tensor,          # [S, D]
    v: torch.Tensor,          # [S, D]
    cfg: SpikeDrivenConfig = SpikeDrivenConfig(),
) -> torch.Tensor:
    """Mask-and-add attention over spike trains (spike_driven.rs):

    sq/sk/sv in {-1,0,1}; scores = sum_t sq_t . sk_t (integer AND-add);
    attention mask = scores > 0; output = mask-weighted sum of sv, decoded
    back to rates.
    """
    sq = encode_rate(q, cfg)                       # [T, S, D]
    sk = encode_rate(k, cfg)
    sv = encode_rate(v, cfg)

    # integer agreement counts between spike trains; CUDA has no integer
    # matmul, and a float64 product of {-1, 0, 1} terms is exact
    scores = torch.einsum("tsd,tud->su", sq.to(torch.float64), sk.to(torch.float64))
    attend = scores > 0
    deg = torch.clamp(torch.sum(attend, dim=-1, keepdim=True), min=1)

    v_rate = decode_rate(sv, cfg)                  # [S, D]
    summed = torch.matmul(attend.to(v_rate.dtype), v_rate)
    return summed / deg


def energy_estimate(cfg: SpikeDrivenConfig, seq: int, dim: int) -> dict:
    """Accumulate-op counts vs vanilla attention's multiply count — the
    87x energy claim's accounting basis (spike ops are ACs, not MACs)."""
    spike_acs = cfg.temporal_coding_steps * seq * seq * dim
    vanilla_macs = 2 * seq * seq * dim
    # energy per op (pJ, 45nm): AC 0.9, MAC 4.6 (Yao et al. accounting)
    return {
        "spike_ac_ops": spike_acs,
        "vanilla_mac_ops": vanilla_macs,
        "energy_ratio": (vanilla_macs * 4.6) / max(spike_acs * 0.9, 1),
    }
