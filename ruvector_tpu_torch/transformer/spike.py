"""Spike scheduler + energy gate — skip/tier pre-selection (port of
ruvector_tpu/transformer/spike.py; numpy).

Reference: ruvector-mincut-gated-transformer/src/spike.rs (SpikeScheduler —
event-driven skip: fire only when input novelty crosses threshold) and
energy_gate.rs (EnergyGate — energy-based decision with confidence,
consulted before the rule-based policy, gate.rs:209-219).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ruvector_tpu_torch.transformer.packets import GateDecision, GatePacket, SpikePacket

Q15 = 32768


@dataclasses.dataclass
class SpikeScheduler:
    """Fires when input novelty (distance to the running input signature)
    exceeds a threshold; tracks spike rate with exponential decay."""

    novelty_threshold: float = 0.1
    rate_decay: float = 0.9
    _signature: np.ndarray | None = None
    _rate: float = 0.0
    _steps: int = 0

    def observe(self, x: np.ndarray) -> SpikePacket:
        x = np.asarray(x, np.float32).reshape(-1)
        self._steps += 1
        if self._signature is None:
            self._signature = x.copy()
            self._rate = self._rate * self.rate_decay + (1 - self.rate_decay)
            return SpikePacket(fired=1, rate_q15=int(self._rate * Q15),
                               novelty_q15=Q15 - 1)
        denom = max(float(np.linalg.norm(self._signature)), 1e-8)
        novelty = float(np.linalg.norm(x - self._signature)) / denom
        fired = novelty > self.novelty_threshold
        if fired:
            self._signature = x.copy()
        self._rate = self._rate * self.rate_decay + (1 - self.rate_decay) * float(fired)
        return SpikePacket(
            fired=int(fired),
            rate_q15=min(int(self._rate * Q15), Q15 - 1),
            novelty_q15=min(int(novelty * Q15), Q15 - 1),
        )


@dataclasses.dataclass(frozen=True)
class EnergyGateConfig:
    allow_energy_max: float = 1.0
    freeze_energy_min: float = 2.0
    confidence_sharpness: float = 2.0


class EnergyGate:
    """Energy-based gate decision with confidence (energy_gate.rs).

    Energy rises with coherence instability; low energy -> Allow with high
    confidence, high energy -> FreezeWrites. Mid-band -> low confidence (the
    controller falls back to the rule-based policy, gate.rs:213-218).
    """

    def __init__(self, config: EnergyGateConfig = EnergyGateConfig()):
        self.config = config

    def energy(self, gate: GatePacket) -> float:
        drop = gate.drop_ratio_q15() / Q15
        boundary = gate.boundary_concentration_q15 / Q15
        lam_term = max(0.0, 1.0 - gate.lam / 100.0)
        partition = min(gate.partition_count / 16.0, 1.0)
        return 2.0 * drop + boundary + lam_term + 0.5 * partition

    def decide(self, gate: GatePacket) -> tuple[GateDecision, float]:
        e = self.energy(gate)
        lo, hi = self.config.allow_energy_max, self.config.freeze_energy_min
        if e <= lo:
            conf = min(1.0, (lo - e) * self.config.confidence_sharpness + 0.7)
            return GateDecision.ALLOW, conf
        if e >= hi:
            conf = min(1.0, (e - hi) * self.config.confidence_sharpness + 0.7)
            return GateDecision.FREEZE_WRITES, conf
        # mid band: uncertain
        return GateDecision.ALLOW, 0.5
