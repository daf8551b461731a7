"""Gate/spike packets, tier decisions, witness records (port of
ruvector_tpu/transformer/packets.py; numpy and hashlib only).

Reference: ruvector-mincut-gated-transformer/src/packets.rs — GatePacket
(:14-65), SpikePacket (:82-120), Witness; gate.rs TierDecision (:30).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib

import numpy as np

Q15_ONE = 32768


@dataclasses.dataclass(frozen=True)
class GatePacket:
    """Coherence signals from the min-cut monitor (packets.rs:14-65)."""

    lam: int = 100                     # current min-cut value (lambda)
    lam_prev: int = 100
    boundary_edges: int = 0
    boundary_concentration_q15: int = 0
    partition_count: int = 1
    flags: int = 0

    FLAG_FORCE_SAFE = 1 << 0
    FLAG_SKIP = 1 << 1
    FLAG_BOUNDARY_IDS_AVAILABLE = 1 << 2

    def force_safe(self) -> bool:
        return bool(self.flags & self.FLAG_FORCE_SAFE)

    def skip_requested(self) -> bool:
        return bool(self.flags & self.FLAG_SKIP)

    def lambda_delta(self) -> int:
        return self.lam - self.lam_prev

    def drop_ratio_q15(self) -> int:
        """How much lambda dropped, as Q15 fraction of lam_prev
        (packets.rs:65)."""
        if self.lam_prev == 0 or self.lam >= self.lam_prev:
            return 0
        return int((self.lam_prev - self.lam) * Q15_ONE / self.lam_prev)


@dataclasses.dataclass(frozen=True)
class SpikePacket:
    """Spiking-scheduler event (packets.rs:82-120)."""

    fired: int = 1
    rate_q15: int = 0
    novelty_q15: int = 0
    top_idx: tuple = ()
    top_w_q15: tuple = ()
    flags: int = 0

    FLAG_SPARSE_MASK = 1 << 0
    FLAG_SPARSE_CONTEXT = 1 << 1

    def is_active(self) -> bool:
        return self.fired != 0

    def use_sparse_mask(self) -> bool:
        return bool(self.flags & self.FLAG_SPARSE_MASK)


class GateDecision(enum.Enum):
    ALLOW = "allow"
    FREEZE_WRITES = "freeze_writes"
    FLUSH_KV = "flush_kv"
    QUARANTINE_UPDATES = "quarantine_updates"


class GateReason(enum.Enum):
    NONE = "none"
    FORCED_BY_FLAG = "forced_by_flag"
    LAMBDA_BELOW_MIN = "lambda_below_min"
    LAMBDA_DROPPED_FAST = "lambda_dropped_fast"
    BOUNDARY_SPIKE = "boundary_spike"
    BOUNDARY_CONCENTRATION_SPIKE = "boundary_concentration_spike"
    PARTITION_DRIFT = "partition_drift"
    SPIKE_STORM = "spike_storm"


@dataclasses.dataclass(frozen=True)
class TierDecision:
    """Output of GateController.evaluate (gate.rs:30-66, 195-297)."""

    decision: GateDecision
    reason: GateReason
    tier: int                   # 0 normal / 1 reduced / 2 safe / 3 skip
    skip: bool
    layers_to_run: int
    effective_seq_len: int
    effective_window: int


@dataclasses.dataclass
class Witness:
    """Deterministic audit record of one inference (packets.rs Witness;
    model.rs:640 witness creation). logits_hash is sha256 of the raw logits
    bytes — same inputs ⇒ same hash (tests/determinism.rs)."""

    tier: int
    decision: GateDecision
    reason: GateReason
    kv_writes_enabled: int
    external_writes_enabled: int
    layers_run: int
    early_exit_layer: int
    logits_hash: str

    @staticmethod
    def hash_logits(logits: np.ndarray) -> str:
        return hashlib.sha256(np.ascontiguousarray(logits).tobytes()).hexdigest()


@dataclasses.dataclass
class InferOutput:
    logits: np.ndarray | None = None
    witness: Witness | None = None
    stats: dict = dataclasses.field(default_factory=dict)
