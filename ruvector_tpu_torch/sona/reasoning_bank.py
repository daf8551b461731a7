"""ReasoningBank — k-means pattern extraction over trajectory embeddings.

Reference: sona/src/reasoning_bank.rs — trajectory embedding = normalized
mean of (query, step activations) weighted by reward (:86-148), k-means++
init + Lloyd iterations (:150-346), find_similar (:348), prune/consolidate
(:387-430).

The port's own copy of ruvector_tpu/sona/reasoning_bank.py: host numpy,
as there (cluster counts are tiny), so the centroids are the same bits.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ruvector_tpu_torch.sona.types import LearnedPattern, QueryTrajectory


@dataclasses.dataclass(frozen=True)
class PatternConfig:
    k_clusters: int = 8
    kmeans_iters: int = 10
    min_cluster_size: int = 2
    quality_threshold: float = 0.3
    embedding_dim: int = 256
    max_trajectories: int = 4096


@dataclasses.dataclass
class _StoredTrajectory:
    embedding: np.ndarray
    quality: float
    cluster: int | None = None


class ReasoningBank:
    def __init__(self, config: PatternConfig):
        self.config = config
        self.trajectories: list[_StoredTrajectory] = []
        self.patterns: dict[int, LearnedPattern] = {}
        self._next_pattern_id = 0

    # -- ingestion -----------------------------------------------------------

    def embed_trajectory(self, t: QueryTrajectory) -> np.ndarray:
        """Reward-weighted mean of query + step activations, L2-normalized
        (reasoning_bank.rs:86-148)."""
        d = self.config.embedding_dim
        acc = np.zeros(d, np.float32)
        q = np.asarray(t.query_embedding, np.float32)
        acc[: min(len(q), d)] += q[:d]
        total_w = 1.0
        for step in t.steps:
            a = np.asarray(step.activations, np.float32)
            w = max(step.reward, 0.1)
            acc[: min(len(a), d)] += w * a[:d]
            total_w += w
        acc /= total_w
        norm = np.linalg.norm(acc)
        if norm > 1e-8:
            acc /= norm
        return acc

    def add_trajectory(self, t: QueryTrajectory):
        if len(self.trajectories) >= self.config.max_trajectories:
            self.trajectories.pop(0)
        self.trajectories.append(
            _StoredTrajectory(self.embed_trajectory(t), t.final_quality)
        )

    # -- k-means extraction --------------------------------------------------

    def _kmeans_pp_init(self, x: np.ndarray, k: int) -> np.ndarray:
        """Deterministic k-means++ (first point = index 0; D² argmax after —
        the reference uses deterministic selection, reasoning_bank.rs:230)."""
        centroids = [x[0]]
        for _ in range(1, k):
            d2 = np.min(
                [np.sum((x - c) ** 2, axis=1) for c in centroids], axis=0
            )
            centroids.append(x[int(np.argmax(d2))])
        return np.stack(centroids)

    def extract_patterns(self) -> list[LearnedPattern]:
        n = len(self.trajectories)
        if n == 0:
            return []
        k = min(self.config.k_clusters, n)
        x = np.stack([t.embedding for t in self.trajectories])
        centroids = self._kmeans_pp_init(x, k)

        for _ in range(self.config.kmeans_iters):
            d2 = ((x[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
            assign = d2.argmin(axis=1)
            for c in range(k):
                members = x[assign == c]
                if len(members):
                    centroids[c] = members.mean(axis=0)

        out = []
        now = time.time()
        for c in range(k):
            idx = np.nonzero(assign == c)[0]
            if len(idx) < self.config.min_cluster_size:
                continue
            qualities = [self.trajectories[i].quality for i in idx]
            avg_q = float(np.mean(qualities))
            if avg_q < self.config.quality_threshold:
                continue
            pid = self._next_pattern_id
            self._next_pattern_id += 1
            pattern = LearnedPattern(
                id=pid, centroid=centroids[c].copy(), avg_quality=avg_q,
                support=len(idx), created_at=now,
            )
            self.patterns[pid] = pattern
            out.append(pattern)
        for i, c in enumerate(assign):
            self.trajectories[i].cluster = int(c)
        return out

    # -- retrieval / maintenance ---------------------------------------------

    def find_similar(self, query: np.ndarray, k: int = 3) -> list[LearnedPattern]:
        if not self.patterns:
            return []
        q = np.asarray(query, np.float32)
        qn = q / max(np.linalg.norm(q), 1e-8)
        scored = []
        for p in self.patterns.values():
            c = p.centroid / max(np.linalg.norm(p.centroid), 1e-8)
            scored.append((float(qn[: len(c)] @ c[: len(qn)]), p))
        scored.sort(key=lambda s: -s[0])
        for _, p in scored[:k]:
            p.access_count += 1
        return [p for _, p in scored[:k]]

    def prune_patterns(self, min_quality: float, min_accesses: int,
                       max_age_secs: float):
        now = time.time()
        drop = [
            pid for pid, p in self.patterns.items()
            if p.avg_quality < min_quality
            and p.access_count < min_accesses
            and (now - p.created_at) > max_age_secs
        ]
        for pid in drop:
            del self.patterns[pid]

    def consolidate(self, similarity_threshold: float = 0.95):
        """Merge near-duplicate patterns (reasoning_bank.rs:410-430)."""
        pids = sorted(self.patterns)
        merged: set[int] = set()
        for i, a in enumerate(pids):
            if a in merged:
                continue
            pa = self.patterns[a]
            ca = pa.centroid / max(np.linalg.norm(pa.centroid), 1e-8)
            for b in pids[i + 1:]:
                if b in merged:
                    continue
                pb = self.patterns[b]
                cb = pb.centroid / max(np.linalg.norm(pb.centroid), 1e-8)
                if float(ca @ cb) >= similarity_threshold:
                    w = pa.support + pb.support
                    pa.centroid = (pa.centroid * pa.support
                                   + pb.centroid * pb.support) / w
                    pa.avg_quality = (pa.avg_quality * pa.support
                                      + pb.avg_quality * pb.support) / w
                    pa.support = w
                    merged.add(b)
        for b in merged:
            del self.patterns[b]

    def clear_trajectories(self):
        self.trajectories.clear()

    @property
    def trajectory_count(self) -> int:
        return len(self.trajectories)

    @property
    def pattern_count(self) -> int:
        return len(self.patterns)
