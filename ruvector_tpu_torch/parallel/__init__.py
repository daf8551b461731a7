"""Multi-rank execution on torch.distributed (port of ruvector_tpu/parallel):
the process mesh and its launcher, the halo plans and the sharded GNN
forward and train step, tensor, expert, pipeline and sequence
parallelism, multi-host bring-up, the sharded gated graph transformer,
and the host-side orderings for block execution."""

from ruvector_tpu_torch.parallel.ep import (
    EpConfig,
    ep_init,
    make_ep_forward,
    reference_ep_forward,
)
from ruvector_tpu_torch.parallel.gated import (
    GatedShard,
    shard_block_dense,
    sharded_gate_state_init,
    sharded_step,
    sharded_value_and_grad,
)
from ruvector_tpu_torch.parallel.halo import (
    halo_exchange,
    make_blocked_layer_forward,
    make_blocked_train_step,
    make_overlap_layer_forward,
    make_sharded_layer_forward,
    make_sharded_mp_forward,
    make_sharded_train_step,
)
from ruvector_tpu_torch.parallel.mesh import Mesh, device_count, make_mesh, run_ranks
from ruvector_tpu_torch.parallel.ordering import (
    graph_grow_blocks,
    halo_fraction,
    recursive_bisection_order,
)
from ruvector_tpu_torch.parallel.partition import (
    HaloPlan,
    OverlapPlan,
    block_partition,
    build_halo_plan,
    build_overlap_plan,
    pad_features_for_plan,
)
from ruvector_tpu_torch.parallel.pp import make_pp_forward, reference_pp_forward
from ruvector_tpu_torch.parallel.sp import make_ring_attention, reference_attention
from ruvector_tpu_torch.parallel.tp import (
    TpLayerConfig,
    make_tp_layer_forward,
    reference_tp_layer_forward,
    tp_layer_init,
    tp_param_specs,
)

__all__ = [
    "EpConfig", "GatedShard", "HaloPlan", "Mesh", "OverlapPlan", "TpLayerConfig",
    "block_partition", "build_halo_plan", "build_overlap_plan", "device_count", "ep_init",
    "graph_grow_blocks", "halo_exchange", "halo_fraction", "make_blocked_layer_forward",
    "make_blocked_train_step", "make_ep_forward", "make_mesh", "make_overlap_layer_forward",
    "make_pp_forward", "make_ring_attention", "make_sharded_layer_forward",
    "make_sharded_mp_forward", "make_sharded_train_step", "make_tp_layer_forward",
    "pad_features_for_plan", "recursive_bisection_order", "reference_attention",
    "reference_ep_forward", "reference_pp_forward", "reference_tp_layer_forward", "run_ranks",
    "shard_block_dense", "sharded_gate_state_init", "sharded_step", "sharded_value_and_grad",
    "tp_layer_init", "tp_param_specs",
]
