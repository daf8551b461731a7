"""Attention: the mechanism registry and its mechanisms (scaled-dot, flash,
linear, local-global, edge-featured, hyperbolic, diffusion, sliced
Wasserstein, centroid OT, sheaf, information bottleneck, dual-space, mixed
curvature, Lorentz cascade, coherence-gated, min-cut gated, mixture of
experts), graph RoPE, the sparse mask builder, the trainable adapter, the
min-cut gate (host Dinic and the device push-relabel) with its
hysteresis, the coherence-gated transformer (CGT) and the SDK (builder,
pipeline, presets).

Every mechanism has the batched form attend(q [B, D], k [B, S, D],
v [B, S, Dv], mask [B, S]) -> [B, Dv] (local-global and sheaf the
sequence form over [S, D]); `get_attention(name)` returns it and
`list_attention()` the names.
"""

from ruvector_tpu_torch.attention.base import (
    AttentionMechanism,
    get_attention,
    list_attention,
    register_attention,
)
from ruvector_tpu_torch.attention.edge_featured import (
    EdgeFeaturedConfig,
    edge_featured_apply,
    edge_featured_init,
)
from ruvector_tpu_torch.attention.flash import flash_attention
from ruvector_tpu_torch.attention.hyperbolic import (
    exp_map,
    hyperbolic_attention,
    log_map,
    mobius_add,
    mobius_scalar_mult,
    poincare_distance,
    project_to_ball,
)
from ruvector_tpu_torch.attention.linear_attn import (
    LinearAttentionConfig,
    linear_attention_apply,
    linear_attention_init,
)
from ruvector_tpu_torch.attention.local_global import local_global_attention
from ruvector_tpu_torch.attention.mask import SparseMaskBuilder
from ruvector_tpu_torch.attention.mincut import (
    HysteresisState,
    MincutGateConfig,
    attn_mincut,
    dynamic_min_cut,
    hysteresis_apply,
    hysteresis_init,
)
from ruvector_tpu_torch.attention.mincut_device import mincut_gate_device, mincut_gate_stats
from ruvector_tpu_torch.attention.moe import (
    MoEAttentionConfig,
    moe_attention_apply,
    moe_attention_init,
)
from ruvector_tpu_torch.attention.rope import graph_rope_encode, rope_rotate
from ruvector_tpu_torch.attention.scaled_dot import scaled_dot_attention
from ruvector_tpu_torch.attention.sdk import PRESETS, AttentionBuilder, AttentionPipeline, preset
from ruvector_tpu_torch.attention.trainable import Gradients, TrainableAttention

# the rest of the family registers itself on import
from ruvector_tpu_torch.attention import dual_space as _dual_space  # noqa: F401
from ruvector_tpu_torch.attention import info_bottleneck as _ib  # noqa: F401
from ruvector_tpu_torch.attention import mixed_curvature as _mixed  # noqa: F401
from ruvector_tpu_torch.attention import pde as _pde  # noqa: F401
from ruvector_tpu_torch.attention import sheaf as _sheaf  # noqa: F401
from ruvector_tpu_torch.attention import topology as _topology  # noqa: F401
from ruvector_tpu_torch.attention import transport as _transport  # noqa: F401
from ruvector_tpu_torch.attention.cgt import (
    CgtConfig,
    ComputeLane,
    EarlyExitConfig,
    ExitReason,
    SparseResidualConfig,
    TokenRouterConfig,
    cgt_block_apply,
    cgt_forward,
    cgt_init,
    lane_statistics,
    residual_sparse_mask,
    route_by_energy,
    run_with_early_exit,
    tune_thresholds,
)

__all__ = [
    "AttentionMechanism", "get_attention", "list_attention", "register_attention",
    "scaled_dot_attention", "flash_attention",
    "LinearAttentionConfig", "linear_attention_init", "linear_attention_apply",
    "local_global_attention",
    "EdgeFeaturedConfig", "edge_featured_init", "edge_featured_apply",
    "poincare_distance", "mobius_add", "mobius_scalar_mult", "exp_map", "log_map",
    "project_to_ball", "hyperbolic_attention",
    "graph_rope_encode", "rope_rotate",
    "SparseMaskBuilder", "TrainableAttention", "Gradients",
    "mincut_gate_device", "mincut_gate_stats",
    "MincutGateConfig", "attn_mincut", "dynamic_min_cut", "HysteresisState",
    "hysteresis_init", "hysteresis_apply",
    "MoEAttentionConfig", "moe_attention_init", "moe_attention_apply",
    "AttentionBuilder", "AttentionPipeline", "preset", "PRESETS",
    "CgtConfig", "ComputeLane", "EarlyExitConfig", "ExitReason", "SparseResidualConfig",
    "TokenRouterConfig", "cgt_block_apply", "cgt_forward", "cgt_init", "lane_statistics",
    "residual_sparse_mask", "route_by_energy", "run_with_early_exit", "tune_thresholds",
]
