"""Temporal tiered tensor store: the bit width follows access recency and
frequency (port of ruvector_tpu/ops/temporal_tiers.py; reference
ruvector-temporal-tensor tier_policy.rs:1-49).

Chunks live as int8 (hot), int4 (warm) or int4 codes with each nibble's
lowest bit dropped (cold, 8 levels) from ops.quantization, on the store's
device. The access score hits * exp(-decay * age) drives demotion and
promotion in a sweep; writes land in the hot tier. The clock is
injectable (`clock=`), as tests need.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.ops.quantization import (
    int4_dequantize,
    int4_quantize,
    scalar_dequantize,
    scalar_quantize,
)


@dataclasses.dataclass(frozen=True)
class TierPolicyConfig:
    """tier_policy.rs thresholds: score = hits * exp(-decay * age)."""

    hot_threshold: float = 0.5     # score above -> 8-bit
    warm_threshold: float = 0.05   # score above -> 4-bit; below -> 3-bit levels
    decay_per_second: float = 0.1
    demote_interval_s: float = 1.0


class TemporalTensorStore:
    """Chunked tensor store with per-chunk temporal tiering: write(chunk_id,
    array), read(chunk_id), tick() (the demotion and promotion sweep)."""

    def __init__(self, dim: int, policy: TierPolicyConfig = TierPolicyConfig(),
                 clock=time.monotonic, device=None):
        self.dim = dim
        self.policy = policy
        self.clock = clock
        self.device = resolve_device(device)
        self._chunks: dict[int, dict] = {}
        self._last_sweep = clock()

    def _score(self, meta: dict) -> float:
        age = self.clock() - meta["last_access"]
        return meta["hits"] * np.exp(-self.policy.decay_per_second * age)

    def _touch(self, meta: dict):
        meta["hits"] = meta["hits"] * 0.9 + 1.0
        meta["last_access"] = self.clock()

    def write(self, chunk_id: int, array) -> None:
        if isinstance(array, torch.Tensor):
            x = array.to(device=self.device, dtype=torch.float32)
        else:
            x = torch.from_numpy(np.asarray(array, np.float32)).to(self.device)
        if x.shape[-1] != self.dim:
            raise ValueError(f"chunk width {x.shape[-1]} != store dim {self.dim}")
        self._chunks[chunk_id] = {"tier": "hot", "data": scalar_quantize(x),
                                  "shape": tuple(x.shape), "hits": 1.0,
                                  "last_access": self.clock()}

    def read(self, chunk_id: int) -> torch.Tensor:
        meta = self._chunks[chunk_id]
        self._touch(meta)
        if meta["tier"] == "hot":
            return scalar_dequantize(meta["data"])
        return int4_dequantize(meta["data"])      # warm and cold

    def tier_of(self, chunk_id: int) -> str:
        return self._chunks[chunk_id]["tier"]

    def tick(self, force: bool = False):
        """The demotion and promotion sweep (the background tier policy)."""
        now = self.clock()
        if not force and now - self._last_sweep < self.policy.demote_interval_s:
            return
        self._last_sweep = now
        for meta in self._chunks.values():
            score = self._score(meta)
            target = ("hot" if score >= self.policy.hot_threshold
                      else "warm" if score >= self.policy.warm_threshold else "cold")
            if target != meta["tier"]:
                self._retier(meta, target)

    def _retier(self, meta: dict, target: str):
        full = (scalar_dequantize(meta["data"]) if meta["tier"] == "hot"
                else int4_dequantize(meta["data"]))
        if target == "hot":
            meta["data"] = scalar_quantize(full)
        elif target == "warm":
            meta["data"] = int4_quantize(full)
        else:   # cold: 3-bit levels inside the int4 container
            q = int4_quantize(full)
            meta["data"] = dataclasses.replace(q, packed=q.packed & 0xEE)
        meta["tier"] = target

    def stats(self) -> dict:
        tiers = {"hot": 0, "warm": 0, "cold": 0}
        bytes_used = 0
        bytes_full = 0
        for meta in self._chunks.values():
            tiers[meta["tier"]] += 1
            n = int(np.prod(meta["shape"][:-1]))
            bytes_full += n * self.dim * 4
            bytes_used += n * (self.dim if meta["tier"] == "hot" else (self.dim + 1) // 2)
        return {**tiers, "compression_ratio": bytes_full / max(bytes_used, 1)}
