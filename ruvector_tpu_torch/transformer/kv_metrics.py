"""KV-cache quality tracking + adaptive tier policy (port of
ruvector_tpu/transformer/kv_metrics.py).

Reference: ruvector-mincut-gated-transformer/src/kv_cache/{metrics,policy}.rs
— MemoryStats with tier percentages, QualityFeedback (from perplexity or
accuracy), QualityTracker with stability/improvement detection, and the
adaptive policy that widens the hot tier when quality degrades.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from ruvector_tpu_torch.transformer.kv_cache import KVCacheConfig


@dataclasses.dataclass
class MemoryStats:
    hot_tokens: int
    warm_tokens: int
    archive_tokens: int
    head_dim: int
    heads: int

    def tier_percentages(self) -> tuple[float, float, float]:
        total = max(self.hot_tokens + self.warm_tokens + self.archive_tokens, 1)
        return (self.hot_tokens / total, self.warm_tokens / total,
                self.archive_tokens / total)

    def bytes_used(self) -> int:
        per_tok = self.heads * self.head_dim
        return (self.hot_tokens * per_tok * 4          # f32
                + self.warm_tokens * (per_tok + 4)     # int8 + scale
                + self.archive_tokens * (per_tok // 2 + 4))  # int4 + scale

    def memory_saved_vs_f32(self) -> float:
        total = self.hot_tokens + self.warm_tokens + self.archive_tokens
        full = total * self.heads * self.head_dim * 4
        return 1.0 - self.bytes_used() / max(full, 1)


@dataclasses.dataclass
class QualityFeedback:
    quality: float              # 1.0 = perfect
    timestamp: float = 0.0

    @staticmethod
    def from_ppl(ppl: float, baseline_ppl: float) -> "QualityFeedback":
        """Quality = baseline/current perplexity ratio, capped at 1
        (metrics.rs:78-92)."""
        if ppl <= 0 or baseline_ppl <= 0:
            return QualityFeedback(0.0)
        return QualityFeedback(min(baseline_ppl / ppl, 1.0))

    @staticmethod
    def from_accuracy(acc: float) -> "QualityFeedback":
        return QualityFeedback(max(0.0, min(acc, 1.0)))


class QualityTracker:
    """Rolling quality with stability/improvement detection
    (metrics.rs:163-250)."""

    def __init__(self, quality_target: float = 0.95, window: int = 32):
        self.quality_target = quality_target
        self.history: deque[float] = deque(maxlen=window)

    def record(self, feedback: QualityFeedback):
        self.history.append(feedback.quality)

    @property
    def current(self) -> float:
        return self.history[-1] if self.history else 1.0

    def mean(self) -> float:
        return sum(self.history) / len(self.history) if self.history else 1.0

    def meets_target(self) -> bool:
        return self.mean() >= self.quality_target

    def is_stable(self, threshold: float = 0.02) -> bool:
        if len(self.history) < 4:
            return True
        vals = list(self.history)[-8:]
        return max(vals) - min(vals) <= threshold

    def is_improving(self) -> bool:
        if len(self.history) < 4:
            return False
        vals = list(self.history)
        half = len(vals) // 2
        return (sum(vals[half:]) / (len(vals) - half)
                > sum(vals[:half]) / half)


@dataclasses.dataclass
class TierPolicy:
    """Adaptive tier sizing (policy.rs): quality below target -> widen the
    hot (exact) tier; comfortably above -> shrink it for memory."""

    min_hot: int = 8
    max_hot: int = 128
    step: int = 8

    def adapt(self, cfg: KVCacheConfig, tracker: QualityTracker) -> KVCacheConfig:
        hot = cfg.hot_capacity
        if not tracker.meets_target():
            hot = min(hot + self.step, self.max_hot)
        elif tracker.is_stable() and tracker.mean() > tracker.quality_target + 0.03:
            hot = max(hot - self.step, self.min_hot)
        if hot == cfg.hot_capacity:
            return cfg
        return dataclasses.replace(cfg, hot_capacity=hot)
