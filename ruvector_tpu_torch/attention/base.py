"""Attention mechanism registry (port of ruvector_tpu/attention/base.py).

A registry of named mechanisms in place of the reference's trait
hierarchy. Each entry says how to make its parameters (None for a
parameter-free mechanism) and how to apply it to a batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class AttentionMechanism:
    """A named attention mechanism.

    init: (seed, config) -> parameters (or None for parameter-free).
    apply: (params, config, q, k, v, mask, **kw) -> output.
    """

    name: str
    init: Callable[..., Any] | None
    apply: Callable[..., Any]
    default_config: Any = None


_REGISTRY: dict[str, AttentionMechanism] = {}


def register_attention(mech: AttentionMechanism) -> AttentionMechanism:
    _REGISTRY[mech.name] = mech
    return mech


def get_attention(name: str) -> AttentionMechanism:
    if name not in _REGISTRY:
        # importing the package registers every mechanism
        import ruvector_tpu_torch.attention  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown attention mechanism {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_attention() -> list[str]:
    import ruvector_tpu_torch.attention  # noqa: F401

    return sorted(_REGISTRY)
