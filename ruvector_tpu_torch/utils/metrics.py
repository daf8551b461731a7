"""Metrics: counters/histograms with Prometheus text exposition (the
port's own copy of ruvector_tpu/utils/metrics.py; pure Python).

Reference: ruvector-metrics/src/lib.rs:16-50 — registry with per-collection
search/insert latency counters + histograms, /health and /ready endpoints
(ruvector-server/src/lib.rs:71-72). This is the host-side observability
plane; device-side numbers (edges/s, step time, halo overlap) are recorded
into the same registry by the training loop.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict


class Counter:
    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] += value

    def get(self, **labels) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        for key, v in sorted(self._values.items()):
            lbl = ",".join(f'{k}="{val}"' for k, val in key)
            lines.append(f"{self.name}{{{lbl}}} {v}" if lbl else f"{self.name} {v}")
        return lines


DEFAULT_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5)


class Histogram:
    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = sorted(buckets)
        self._counts: dict[tuple, list[int]] = {}
        self._sum: dict[tuple, float] = defaultdict(float)
        self._total: dict[tuple, int] = defaultdict(int)
        self._lock = threading.Lock()

    def observe(self, value: float, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            counts[bisect.bisect_left(self.buckets, value)] += 1
            self._sum[key] += value
            self._total[key] += 1

    def time(self, **labels):
        """Context manager recording elapsed seconds."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0, **labels)

        return _Timer()

    def percentile(self, p: float, **labels) -> float:
        key = tuple(sorted(labels.items()))
        counts = self._counts.get(key)
        if not counts:
            return 0.0
        total = self._total[key]
        target = p / 100.0 * total
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                return self.buckets[i] if i < len(self.buckets) else float("inf")
        return float("inf")

    def expose(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for key in sorted(self._counts):
            lbl_base = list(key)
            acc = 0
            for i, b in enumerate(self.buckets):
                acc += self._counts[key][i]
                lbl = ",".join(f'{k}="{v}"' for k, v in lbl_base + [("le", b)])
                lines.append(f"{self.name}_bucket{{{lbl}}} {acc}")
            lbl = ",".join(f'{k}="{v}"' for k, v in lbl_base + [("le", "+Inf")])
            lines.append(f"{self.name}_bucket{{{lbl}}} {self._total[key]}")
            lbl2 = ",".join(f'{k}="{v}"' for k, v in lbl_base)
            brace = f"{{{lbl2}}}" if lbl2 else ""
            lines.append(f"{self.name}_sum{brace} {self._sum[key]}")
            lines.append(f"{self.name}_count{brace} {self._total[key]}")
        return lines


class MetricsRegistry:
    """Named metric registry with text exposition (ruvector-metrics parity)."""

    def __init__(self):
        self._metrics: dict[str, Counter | Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        if name not in self._metrics:
            self._metrics[name] = Counter(name, help)
        return self._metrics[name]

    def histogram(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
        if name not in self._metrics:
            self._metrics[name] = Histogram(name, help, buckets)
        return self._metrics[name]

    def expose(self) -> str:
        lines = []
        for m in self._metrics.values():
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def health(self) -> dict:
        return {"status": "healthy"}

    def ready(self) -> dict:
        return {"status": "ready"}
