"""GateController — authoritative tier selection (host control plane; port
of ruvector_tpu/transformer/gate.py).

Reference: ruvector-mincut-gated-transformer/src/gate.rs:195-330. The gate
runs on host (it consumes tiny scalar packets, not tensors) and selects the
tier the model runs.
"""

from __future__ import annotations

from ruvector_tpu_torch.transformer.config import GatePolicy, TransformerConfig
from ruvector_tpu_torch.transformer.packets import (
    GateDecision,
    GatePacket,
    GateReason,
    SpikePacket,
    TierDecision,
)


class GateController:
    def __init__(self, policy: GatePolicy, config: TransformerConfig):
        self.policy = policy
        self.config = config

    # -- tier constructors (gate.rs tier_* helpers) --------------------------

    def _tier_normal(self) -> TierDecision:
        return TierDecision(
            GateDecision.ALLOW, GateReason.NONE, tier=0, skip=False,
            layers_to_run=self.config.layers,
            effective_seq_len=self.config.seq_len_max,
            effective_window=self.config.window_normal,
        )

    def _tier_reduced(self, reason: GateReason) -> TierDecision:
        return TierDecision(
            GateDecision.ALLOW, reason, tier=1, skip=False,
            layers_to_run=self.config.layers_degraded,
            effective_seq_len=self.config.seq_len_degraded,
            effective_window=self.config.window_degraded,
        )

    def _tier_safe(self, reason: GateReason) -> TierDecision:
        return TierDecision(
            GateDecision.FREEZE_WRITES, reason, tier=2, skip=False,
            layers_to_run=1,
            effective_seq_len=self.config.seq_len_safe,
            effective_window=4,
        )

    def _tier_with_intervention(
        self, decision: GateDecision, reason: GateReason
    ) -> TierDecision:
        return TierDecision(
            decision, reason, tier=2, skip=False,
            layers_to_run=1,
            effective_seq_len=self.config.seq_len_safe,
            effective_window=4,
        )

    def _tier_skip(self, reason: GateReason) -> TierDecision:
        return TierDecision(
            GateDecision.ALLOW, reason, tier=3, skip=True,
            layers_to_run=0, effective_seq_len=0, effective_window=0,
        )

    # -- evaluation (gate.rs:195-297, rule order preserved) ------------------

    def evaluate(
        self, gate: GatePacket, spikes: SpikePacket | None = None
    ) -> TierDecision:
        if gate.skip_requested():
            return self._tier_skip(GateReason.FORCED_BY_FLAG)
        if gate.force_safe():
            return self._tier_safe(GateReason.FORCED_BY_FLAG)

        if spikes is not None:
            if not spikes.is_active():
                return self._tier_skip(GateReason.NONE)
            if spikes.rate_q15 > self.policy.spike_rate_q15_max:
                return self._tier_safe(GateReason.SPIKE_STORM)

        if gate.lam < self.policy.lambda_min:
            return self._tier_with_intervention(
                GateDecision.QUARANTINE_UPDATES, GateReason.LAMBDA_BELOW_MIN
            )
        if gate.drop_ratio_q15() > self.policy.drop_ratio_q15_max:
            return self._tier_with_intervention(
                GateDecision.FLUSH_KV, GateReason.LAMBDA_DROPPED_FAST
            )
        if gate.boundary_edges > self.policy.boundary_edges_max:
            return self._tier_reduced(GateReason.BOUNDARY_SPIKE)
        if gate.boundary_concentration_q15 > self.policy.boundary_concentration_q15_max:
            return self._tier_reduced(GateReason.BOUNDARY_CONCENTRATION_SPIKE)
        if gate.partition_count > self.policy.partitions_max:
            return self._tier_reduced(GateReason.PARTITION_DRIFT)
        return self._tier_normal()

    def should_allow_kv_writes(self, gate: GatePacket) -> bool:
        """gate.rs:297-310."""
        if gate.lam < self.policy.lambda_min:
            return self.policy.allow_kv_write_when_unstable
        if gate.drop_ratio_q15() > self.policy.drop_ratio_q15_max:
            return False
        return True

    def should_allow_external_writes(self, gate: GatePacket) -> bool:
        """gate.rs:311-330."""
        if not self.config.enable_external_writes:
            return False
        if gate.lam < self.policy.lambda_min:
            return self.policy.allow_external_write_when_unstable
        if gate.drop_ratio_q15() > self.policy.drop_ratio_q15_max:
            return False
        if gate.boundary_edges > self.policy.boundary_edges_max:
            return False
        return True
