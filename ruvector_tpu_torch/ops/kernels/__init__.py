"""Hand-written CUDA kernels of the port (sources in `csrc/`), one wrapper
module per TPU kernel, each with its plain PyTorch version beside it.

A wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises. Each wrapper counts its launches in a
plain integer attribute (`<wrapper>.launches`).
"""

from ruvector_tpu_torch.ops.kernels.block_dense_attn import (
    block_dense_attention,
    block_dense_layer_fused,
)
from ruvector_tpu_torch.ops.kernels.flash_neighbor import flash_neighbor_attention
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (
    block_gate_signature,
    block_gate_signature_ln_x,
    block_gate_signature_x,
    gated_block_attention_bwd,
    gated_block_attention_fwd,
)
from ruvector_tpu_torch.ops.kernels.gated_block_layer import (
    gated_block_layer,
    gated_block_layer_with_sig,
)
from ruvector_tpu_torch.ops.kernels.mincut_gate_block import mincut_gate_block_from_x
from ruvector_tpu_torch.ops.kernels.neighbor_mix import fused_neighbor_mix
from ruvector_tpu_torch.ops.kernels.spmm import spmm_gather

KERNELS = (block_dense_layer_fused, block_dense_attention, fused_neighbor_mix,
           gated_block_layer, gated_block_layer_with_sig, gated_block_attention_fwd,
           gated_block_attention_bwd, block_gate_signature, block_gate_signature_x,
           block_gate_signature_ln_x, mincut_gate_block_from_x, flash_neighbor_attention,
           spmm_gather)


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "block_dense_attention", "block_dense_layer_fused",
           "block_gate_signature", "block_gate_signature_ln_x", "block_gate_signature_x",
           "flash_neighbor_attention", "fused_neighbor_mix", "gated_block_attention_bwd",
           "gated_block_attention_fwd", "gated_block_layer", "gated_block_layer_with_sig",
           "launch_counts", "mincut_gate_block_from_x", "reset_launch_counts", "spmm_gather"]
