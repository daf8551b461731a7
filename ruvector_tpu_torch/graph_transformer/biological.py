"""Biological graph attention: spiking dynamics, STDP, Hebbian learning
(port of ruvector_tpu/graph_transformer/biological.py).

SpikingGraphAttention (biological.rs:848): LIF membrane potentials gate
the neighbor aggregation; spikes are a hard threshold with a sigmoid
straight-through surrogate gradient (soft + (hard - soft).detach(), the
JAX package's stop_gradient). k-winners-take-all lateral inhibition
(:167), STDP edge updates (:512) and Hebbian/Oja rules (:344-424) are
elementwise and outer-product updates; the time loop is a Python loop.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ruvector_tpu_torch.graph.neighbors import NeighborGraph


@dataclasses.dataclass(frozen=True)
class BiologicalConfig:
    threshold: float = 1.0
    leak: float = 0.9              # membrane decay per step
    refractory_drop: float = 1.0   # potential reset after a spike
    k_winners: int = 0             # 0 = no lateral inhibition
    surrogate_slope: float = 4.0


def _spike(v: torch.Tensor, threshold: float, slope: float) -> torch.Tensor:
    """Heaviside spike with a sigmoid surrogate gradient (straight-through)."""
    soft = torch.sigmoid(slope * (v - threshold))
    hard = (v >= threshold).to(v.dtype)
    return soft + (hard - soft).detach()


def k_winners_take_all(v: torch.Tensor, spikes: torch.Tensor, k: int) -> torch.Tensor:
    """Lateral inhibition (biological.rs:167): only the k most depolarized
    spiking nodes keep their spikes."""
    if k <= 0:
        return spikes
    masked = torch.where(spikes > 0.5, v, torch.full_like(v, -math.inf))
    kth = torch.sort(masked).values[-k]
    return spikes * (masked >= kth).to(spikes.dtype)


class SpikingGraphAttention:
    """LIF neurons on the graph's nodes; spikes gate neighbor aggregation."""

    def __init__(self, config: BiologicalConfig = BiologicalConfig()):
        self.config = config

    def forward(self, x: torch.Tensor, graph: NeighborGraph, steps: int = 8):
        """Returns (aggregated [n, d], spike counts [n], final potentials).
        Each step the potentials integrate the input drive and the spiking
        neighbors' messages, spike, reset and (optionally) inhibit."""
        cfg = self.config
        n, d = x.shape
        drive = torch.linalg.vector_norm(x, dim=-1) / math.sqrt(d)
        idx = graph.nbr_idx.long()
        nbr_x = graph.nbr_mask[..., None] * x[idx]          # [n, m, d], the same every step
        v = torch.zeros(n, dtype=x.dtype, device=x.device)
        agg = torch.zeros_like(x)
        counts = torch.zeros(n, dtype=x.dtype, device=x.device)
        for _ in range(steps):
            spk = _spike(v, cfg.threshold, cfg.surrogate_slope)
            spk = k_winners_take_all(v, spk, cfg.k_winners)
            msg = torch.sum(spk[idx][..., None] * nbr_x, dim=1)
            v_new = cfg.leak * v + drive + 0.1 * torch.linalg.vector_norm(msg, dim=-1)
            v = v_new - spk * cfg.refractory_drop
            agg = agg + spk[:, None] * msg
            counts = counts + spk
        return agg / torch.clamp(counts[:, None], min=1.0), counts, v


@dataclasses.dataclass(frozen=True)
class StdpConfig:
    a_plus: float = 0.01
    a_minus: float = 0.012
    tau_plus: float = 20.0
    tau_minus: float = 20.0
    w_min: float = 0.0
    w_max: float = 1.0


def _decay(tau: float, like: torch.Tensor) -> torch.Tensor:
    """exp(-1/tau) in float32, as the JAX package takes it."""
    return torch.exp(torch.tensor(-1.0 / tau, dtype=torch.float32, device=like.device))


def stdp_update(edge_weight, pre_trace, post_trace, pre_spikes, post_spikes,
                graph: NeighborGraph, cfg: StdpConfig = StdpConfig()):
    """One STDP step (biological.rs:512): exponential eligibility traces;
    pre before post potentiates (+A+ * pre trace at a post spike), post
    before pre depresses (-A- * post trace at a pre spike). edge_weight
    [n, m] padded; pre = neighbor j, post = center i. Returns (weights,
    pre trace, post trace)."""
    pre_trace = pre_trace * _decay(cfg.tau_plus, pre_trace) + pre_spikes
    post_trace = post_trace * _decay(cfg.tau_minus, post_trace) + post_spikes
    idx = graph.nbr_idx.long()
    dw = (cfg.a_plus * pre_trace[idx] * post_spikes[:, None]
          - cfg.a_minus * post_trace[:, None] * pre_spikes[idx])
    w = torch.clamp(edge_weight + graph.nbr_mask * dw, cfg.w_min, cfg.w_max)
    return w, pre_trace, post_trace


def hebbian_update(w, pre, post, rule: str = "oja", lr: float = 0.01,
                   norm_bound: float | None = None):
    """Hebbian/Oja update (biological.rs:344-424): hebbian dw = lr post pre;
    oja adds the decay -lr post^2 w that bounds the norm. Optional hard
    norm bound (HebbianNormBound:263-309)."""
    outer = post[:, None] * pre[None, :]
    if rule == "hebbian":
        w = w + lr * outer
    elif rule == "oja":
        w = w + lr * (outer - (post ** 2)[:, None] * w)
    else:
        raise ValueError(rule)
    if norm_bound is not None:
        nrm = torch.linalg.vector_norm(w)
        w = torch.where(nrm > norm_bound, w * (norm_bound / nrm), w)
    return w
