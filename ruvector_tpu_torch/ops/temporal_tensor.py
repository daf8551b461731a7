"""Temporal tensor store: tiered bit widths driven by the access pattern
(port of ruvector_tpu/ops/temporal_tensor.py; reference
ruvector-temporal-tensor, tier_policy.rs:1-49).

The access score is access_count * 1024 / (now - last_access + 1): hot
(>= 512) keeps 8 bits, warm (>= 64) 7 bits, cold 3 bits, quantised in
groups of 64 with one scale each and packed into uint32 words. Quantising
and packing run on the store's device; the policy and the bookkeeping on
the host; a read returns a device tensor.

Packing: value i of a group holds bits [i b, (i + 1) b) of the group's
little-endian bit stream and word w its bits [32 w, 32 w + 32), which is
the JAX package's layout both for widths that divide 32 (shifted fields)
and for the others (its bit-buffer loop). Words are int32 tensors with
the uint32 bits (ops.quantization.uint32_words gives the numpy view).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.ops.quantization import true_div, u64_from_words, words_from_u64


@dataclasses.dataclass(frozen=True)
class TierPolicy:
    """Defaults of tier_policy.rs:22-30."""

    hot_min_score: int = 512
    warm_min_score: int = 64
    warm_bits: int = 7
    drift_pct_q8: int = 26
    group_len: int = 64

    def select_bits(self, access_count: int, last_access_ts: int, now_ts: int) -> int:
        age = max(now_ts - last_access_ts, 0) + 1
        score = access_count * 1024 // age
        if score >= self.hot_min_score:
            return 8
        if score >= self.warm_min_score:
            return self.warm_bits
        return 3

    def drift_factor(self) -> float:
        return 1.0 + self.drift_pct_q8 / 256.0


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def quantize_bits(x, bits: int, group_len: int = 64, device=None):
    """Group-wise symmetric quantisation to `bits` bits (offset binary),
    packed into uint32 words. Returns (packed [G, W] int32 words, scales
    [G] f32, orig_len), on `device` (a tensor's own device by default)."""
    dev = x.device if isinstance(x, torch.Tensor) and device is None else resolve_device(device)
    x = _as_tensor(x, dev).reshape(-1)
    n = x.numel()
    xp = F.pad(x, (0, (-n) % group_len)).reshape(-1, group_len)
    qmax = (1 << (bits - 1)) - 1
    scales = true_div(torch.clamp(torch.amax(torch.abs(xp), dim=1), min=1e-12), qmax)
    q = torch.clamp(torch.round(xp / scales[:, None]), -qmax - 1, qmax)
    u = (q + (1 << (bits - 1))).to(torch.int64)
    g = u.shape[0]
    nbits = group_len * bits
    words = -(-nbits // 32)
    stream = (u[:, :, None] >> torch.arange(bits, device=dev)) & 1
    stream = F.pad(stream.reshape(g, nbits), (0, words * 32 - nbits))
    packed = (stream.reshape(g, words, 32) << torch.arange(32, device=dev)).sum(-1)
    return words_from_u64(packed), scales, n


def dequantize_bits(packed: torch.Tensor, scales: torch.Tensor, bits: int, orig_len: int,
                    group_len: int = 64) -> torch.Tensor:
    """Inverse of quantize_bits: [orig_len] f32 on the words' device."""
    g = packed.shape[0]
    dev = packed.device
    stream = (u64_from_words(packed)[:, :, None] >> torch.arange(32, device=dev)) & 1
    fields = stream.reshape(g, -1)[:, :group_len * bits].reshape(g, group_len, bits)
    u = (fields << torch.arange(bits, device=dev)).sum(-1)
    q = u.float() - (1 << (bits - 1))
    return (q * scales[:, None]).reshape(-1)[:orig_len]


@dataclasses.dataclass
class _Slot:
    packed: torch.Tensor
    scales: torch.Tensor
    bits: int
    n: int
    shape: tuple
    access_count: int = 0
    last_access_ts: int = 0
    max_abs: float = 0.0


class TemporalTensorStore:
    """Tiered store: writes land at 8 bits; a migration sweep re-packs each
    tensor at the tier its access score earns (tiering.rs semantics). The
    clock is a counter that every write and read advances."""

    def __init__(self, policy: TierPolicy = TierPolicy(), device=None):
        self.policy = policy
        self.device = resolve_device(device)
        self._slots: dict = {}
        self._clock = 0

    def _now(self) -> int:
        self._clock += 1
        return self._clock

    def write(self, key, value):
        v = _as_tensor(value, self.device)
        packed, scales, n = quantize_bits(v, 8, self.policy.group_len)
        now = self._now()
        prev = self._slots.get(key)
        self._slots[key] = _Slot(
            packed=packed, scales=scales, bits=8, n=n, shape=tuple(v.shape),
            access_count=(prev.access_count + 1) if prev else 1,
            last_access_ts=now, max_abs=float(v.abs().max()) if n else 0.0)

    def read(self, key) -> torch.Tensor:
        s = self._slots[key]
        s.access_count += 1
        s.last_access_ts = self._now()
        flat = dequantize_bits(s.packed, s.scales, s.bits, s.n, self.policy.group_len)
        return flat.reshape(s.shape)

    def migrate(self) -> dict:
        """Re-tier every tensor by its current access score; returns {key:
        bits} of the tensors that moved."""
        now = self._clock
        moved = {}
        for key, s in self._slots.items():
            bits = self.policy.select_bits(s.access_count, s.last_access_ts, now)
            if bits != s.bits:
                flat = dequantize_bits(s.packed, s.scales, s.bits, s.n, self.policy.group_len)
                s.packed, s.scales, _ = quantize_bits(flat, bits, self.policy.group_len)
                s.bits = bits
                moved[key] = bits
        return moved

    def tier_of(self, key) -> int:
        return self._slots[key].bits

    def compression_ratio(self, key) -> float:
        s = self._slots[key]
        return (s.n * 4) / (s.packed.nbytes + s.scales.nbytes)
