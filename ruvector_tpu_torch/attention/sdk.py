"""The attention SDK: a builder, a pipeline and named presets (port of
ruvector_tpu/attention/sdk.py; reference ruvector-attention src/sdk/:
AttentionBuilder, builder.rs:16-60, and the presets of presets.rs:6-17).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ruvector_tpu_torch.attention.base import get_attention
from ruvector_tpu_torch.nn.core import make_generator


@dataclasses.dataclass
class BuiltAttention:
    """A configured, optionally parameterised attention callable."""

    name: str
    config: Any
    params: Any
    apply_kwargs: dict

    def __call__(self, q, k, v, mask=None, **kw):
        mech = get_attention(self.name)
        return mech.apply(self.params, self.config, q, k, v, mask,
                          **{**self.apply_kwargs, **kw})


class AttentionBuilder:
    """Fluent builder over the mechanism registry (builder.rs:16-60).

    Parameters are drawn at build() from a torch.Generator (seed 0 unless
    seed() sets an int or a generator), on `device`; they do not reproduce
    the JAX builder's jax.random key.
    """

    def __init__(self, dim: int, device=None):
        self.dim = dim
        self.device = device
        self._name = "scaled_dot"
        self._config: Any = None
        self._kwargs: dict = {}
        self._seed: int | torch.Generator = 0

    def mechanism(self, name: str) -> "AttentionBuilder":
        self._name = name
        return self

    def config(self, cfg: Any) -> "AttentionBuilder":
        self._config = cfg
        return self

    def seed(self, seed: int | torch.Generator) -> "AttentionBuilder":
        self._seed = seed
        return self

    def temperature(self, t: float) -> "AttentionBuilder":
        self._kwargs["temperature"] = t
        return self

    def option(self, **kw) -> "AttentionBuilder":
        self._kwargs.update(kw)
        return self

    def build(self) -> BuiltAttention:
        mech = get_attention(self._name)
        cfg = self._config if self._config is not None else mech.default_config
        params = (mech.init(make_generator(self._seed), cfg, self.device)
                  if mech.init is not None else None)
        return BuiltAttention(self._name, cfg, params, dict(self._kwargs))


class AttentionPipeline:
    """Sequential composition of built attentions: each stage refines the
    query with its attention output (residual chaining)."""

    def __init__(self, stages: list[BuiltAttention]):
        self.stages = stages

    def __call__(self, q, k, v, mask=None):
        x = q
        for stage in self.stages:
            x = x + stage(x, k, v, mask)
        return x


def preset(name: str, dim: int, device=None) -> BuiltAttention:
    """Named presets (presets.rs:6-17) mapped onto the mechanisms."""
    from ruvector_tpu_torch.attention.linear_attn import LinearAttentionConfig
    from ruvector_tpu_torch.attention.moe import MoEAttentionConfig

    b = AttentionBuilder(dim, device)
    name = name.lower()
    if name in ("bert", "t5", "vit", "gpt"):     # gpt: causal through the mask
        return b.mechanism("scaled_dot").build()
    if name == "longformer":
        return b.mechanism("local_global").build()
    if name == "performer":
        return b.mechanism("linear").config(
            LinearAttentionConfig(dim=dim, num_features=max(dim // 2, 16))).build()
    if name == "flash_optimized":
        return b.mechanism("flash").build()
    if name == "switch_transformer":
        return b.mechanism("moe").config(MoEAttentionConfig(dim=dim)).build()
    if name == "hyperbolic_tree":
        return b.mechanism("hyperbolic").build()
    if name == "sparse_transformer":
        return b.mechanism("flash").option(block_size=64).build()
    raise ValueError(f"unknown preset {name!r}")


PRESETS = ["bert", "gpt", "longformer", "performer", "flash_optimized",
           "switch_transformer", "hyperbolic_tree", "t5", "vit", "sparse_transformer"]
