"""Attention: the mechanism registry with the parameter-free scaled-dot
and flash mechanisms, and the device min-cut gate (push-relabel)."""

from ruvector_tpu_torch.attention.base import (
    AttentionMechanism,
    get_attention,
    list_attention,
    register_attention,
)
from ruvector_tpu_torch.attention.flash import flash_attention
from ruvector_tpu_torch.attention.mincut_device import mincut_gate_device, mincut_gate_stats
from ruvector_tpu_torch.attention.scaled_dot import scaled_dot_attention

__all__ = ["AttentionMechanism", "flash_attention", "get_attention", "list_attention",
           "mincut_gate_device", "mincut_gate_stats", "register_attention",
           "scaled_dot_attention"]
