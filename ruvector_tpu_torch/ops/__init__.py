"""Tensor ops of the port: padded-layout message passing (`segment`) and
the hand-written CUDA kernels (`kernels`)."""

from ruvector_tpu_torch.ops.segment import (
    masked_softmax,
    masked_weighted_mean,
    sddmm_padded,
    spmm_padded,
)

__all__ = ["masked_softmax", "masked_weighted_mean", "sddmm_padded", "spmm_padded"]
