"""Transformer + gate-policy configuration (port of
ruvector_tpu/transformer/config.py).

Reference: ruvector-mincut-gated-transformer/src/config.rs — TransformerConfig
with baseline()/micro() presets (:60-105) and GatePolicy thresholds.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    seq_len_max: int = 64
    hidden: int = 256
    heads: int = 4
    layers: int = 4
    window_normal: int = 16
    window_degraded: int = 8
    ffn_mult: int = 4
    logits: int = 1024
    layers_degraded: int = 2
    seq_len_degraded: int = 32
    seq_len_safe: int = 8
    enable_kv_cache: bool = True
    enable_external_writes: bool = True
    vocab: int = 1024
    rope_base: float = 10000.0
    rope_scaling: str = "none"
    rope_scaling_factor: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def ffn_dim(self) -> int:
        return self.hidden * self.ffn_mult

    @staticmethod
    def baseline() -> "TransformerConfig":
        """CPU-baseline preset (config.rs:61-79): seq 64, hidden 256, 4x4."""
        return TransformerConfig()

    @staticmethod
    def micro() -> "TransformerConfig":
        """Edge/WASM preset (config.rs:81-105): seq 32, hidden 128, 4 heads,
        2 layers."""
        return TransformerConfig(
            seq_len_max=32, hidden=128, heads=4, layers=2,
            window_normal=8, window_degraded=4, ffn_mult=4, logits=256,
            layers_degraded=1, seq_len_degraded=16, seq_len_safe=8,
            vocab=256,
        )


@dataclasses.dataclass(frozen=True)
class GatePolicy:
    """Thresholds for the gate controller (config.rs GatePolicy).

    lambda is the min-cut value from the coherence monitor; Q15 values are
    kept as ints in [0, 32768) exactly as the reference wire format.
    """

    lambda_min: int = 10
    drop_ratio_q15_max: int = 16384          # lambda dropped by > 50%
    boundary_edges_max: int = 64
    boundary_concentration_q15_max: int = 26214  # > 0.8
    partitions_max: int = 16
    spike_rate_q15_max: int = 29491          # > 0.9 = spike storm
    allow_kv_write_when_unstable: bool = False
    allow_external_write_when_unstable: bool = False
