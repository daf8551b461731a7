"""Transformer-internal trace: counters + snapshots over witnesses (port of
ruvector_tpu/transformer/trace.py).

Reference: ruvector-mincut-gated-transformer/src/trace.rs (412 LoC) —
feature-gated TraceCounters / TraceSnapshot / TraceState recording every
witness at model.rs:462-464. Host-side by nature (witnesses are already
host records); zero overhead on the device path.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

from ruvector_tpu_torch.transformer.packets import Witness


@dataclasses.dataclass
class TraceSnapshot:
    """Immutable view of the counters at a point in time (trace.rs)."""

    inferences: int
    tier_counts: dict
    decision_counts: dict
    skips: int
    early_exits: int
    total_layers_run: int
    kv_writes_enabled: int
    distinct_logit_hashes: int

    @property
    def mean_layers_per_inference(self) -> float:
        return self.total_layers_run / self.inferences if self.inferences \
            else 0.0


class TraceState:
    """Accumulates witnesses; attach via record() after each infer."""

    def __init__(self, keep_last: int = 256):
        self.inferences = 0
        self.tier_counts: Counter = Counter()
        self.decision_counts: Counter = Counter()
        self.skips = 0
        self.early_exits = 0
        self.total_layers_run = 0
        self.kv_writes_enabled = 0
        self._hashes: set[str] = set()
        self._recent: list[Witness] = []
        self.keep_last = keep_last

    def record(self, witness: Witness):
        self.inferences += 1
        self.tier_counts[witness.tier] += 1
        self.decision_counts[str(witness.decision)] += 1
        if witness.layers_run == 0:
            self.skips += 1
        if witness.early_exit_layer:
            self.early_exits += 1
        self.total_layers_run += witness.layers_run
        self.kv_writes_enabled += witness.kv_writes_enabled
        self._hashes.add(witness.logits_hash)
        self._recent.append(witness)
        if len(self._recent) > self.keep_last:
            self._recent.pop(0)

    def snapshot(self) -> TraceSnapshot:
        return TraceSnapshot(
            inferences=self.inferences,
            tier_counts=dict(self.tier_counts),
            decision_counts=dict(self.decision_counts),
            skips=self.skips,
            early_exits=self.early_exits,
            total_layers_run=self.total_layers_run,
            kv_writes_enabled=self.kv_writes_enabled,
            distinct_logit_hashes=len(self._hashes),
        )

    def recent(self, k: int = 16) -> list[Witness]:
        return self._recent[-k:]
