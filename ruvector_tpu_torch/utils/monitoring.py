"""Event-driven threshold monitoring with callbacks (the port's own copy
of ruvector_tpu/utils/monitoring.py; pure Python).

Reference: ruvector-mincut/src/monitoring/mod.rs (1,082 LoC) — watchers
observe the dynamic min-cut value (and other scalars) and fire registered
callbacks when thresholds are crossed; used to trigger gate recomputation
and alerting. ruvector-replication/src/failover.rs:1-123 layers health
states (healthy | unhealthy | unresponsive) on similar signals.

Host-side by design: monitoring consumes scalars that already left the
device (gate lambda, loss, heartbeat ages) — no device work involved.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass
class ThresholdRule:
    name: str
    threshold: float
    direction: str                      # "above" | "below"
    callback: Callable[[str, float], None]
    hysteresis: float = 0.0             # must re-cross by this margin to rearm
    triggered: bool = False

    def check(self, value: float):
        if self.direction == "above":
            fire = value > self.threshold
            rearm = value < self.threshold - self.hysteresis
        else:
            fire = value < self.threshold
            rearm = value > self.threshold + self.hysteresis
        if fire and not self.triggered:
            self.triggered = True
            self.callback(self.name, value)
        elif rearm:
            self.triggered = False


class MetricWatcher:
    """Watch named scalar streams; fire callbacks on threshold crossings
    (monitoring/mod.rs semantics: edge-triggered with hysteresis rearm)."""

    def __init__(self, window: int = 256):
        self.rules: dict[str, list[ThresholdRule]] = {}
        self.history: dict[str, deque] = {}
        self.window = window

    def watch(self, metric: str, threshold: float, direction: str,
              callback: Callable[[str, float], None],
              hysteresis: float = 0.0, name: str | None = None):
        rule = ThresholdRule(name or f"{metric}_{direction}_{threshold}",
                             threshold, direction, callback, hysteresis)
        self.rules.setdefault(metric, []).append(rule)
        return rule

    def observe(self, metric: str, value: float):
        self.history.setdefault(metric, deque(maxlen=self.window)).append(
            (time.time(), value))
        for rule in self.rules.get(metric, []):
            rule.check(value)

    def recent(self, metric: str, k: int = 16) -> list[float]:
        h = self.history.get(metric, deque())
        return [v for _, v in list(h)[-k:]]


@dataclasses.dataclass
class HealthState:
    """healthy | unhealthy | unresponsive (failover.rs:1-123)."""

    status: str = "healthy"
    consecutive_failures: int = 0
    last_seen: float = dataclasses.field(default_factory=time.time)


class HealthMonitor:
    """Per-member health with failure counting and staleness detection
    (gossip.rs:140-161 failure counters + failover.rs health states)."""

    def __init__(self, unhealthy_after: int = 3,
                 unresponsive_after_s: float = 10.0):
        self.members: dict[str, HealthState] = {}
        self.unhealthy_after = unhealthy_after
        self.unresponsive_after_s = unresponsive_after_s

    def report_success(self, member: str):
        st = self.members.setdefault(member, HealthState())
        st.consecutive_failures = 0
        st.status = "healthy"
        st.last_seen = time.time()

    def report_failure(self, member: str):
        st = self.members.setdefault(member, HealthState())
        st.consecutive_failures += 1
        st.last_seen = time.time()
        if st.consecutive_failures >= self.unhealthy_after:
            st.status = "unhealthy"

    def sweep(self, now: float | None = None) -> dict[str, str]:
        """Mark silent members unresponsive; returns member -> status."""
        now = now if now is not None else time.time()
        for st in self.members.values():
            if now - st.last_seen > self.unresponsive_after_s:
                st.status = "unresponsive"
        return {m: st.status for m, st in self.members.items()}

    def quorum_healthy(self) -> bool:
        """Split-brain guard (failover.rs:79-123): majority healthy."""
        if not self.members:
            return True
        healthy = sum(1 for s in self.members.values()
                      if s.status == "healthy")
        return healthy * 2 > len(self.members)
