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
from ruvector_tpu_torch.ops.kernels.neighbor_mix import fused_neighbor_mix

KERNELS = (block_dense_layer_fused, block_dense_attention, fused_neighbor_mix)


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "block_dense_attention", "block_dense_layer_fused",
           "fused_neighbor_mix", "launch_counts", "reset_launch_counts"]
