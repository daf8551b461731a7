"""Attention gates: the device min-cut gate (push-relabel)."""

from ruvector_tpu_torch.attention.mincut_device import mincut_gate_device, mincut_gate_stats

__all__ = ["mincut_gate_device", "mincut_gate_stats"]
