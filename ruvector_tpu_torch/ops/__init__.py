"""Tensor ops of the port: message passing in the padded and CSR layouts
(`segment`), the degree-bucketed SpMM (`spmm_bucketed`), distances
(`distance`), vector quantization (`quantization`), tiered compression
(`compress`), Q15 fixed point (`q15`), the temporal tiered stores
(`temporal_tensor`, `temporal_tiers`) and the hand-written CUDA kernels
(`kernels`)."""

from ruvector_tpu_torch.ops.distance import (
    cosine_similarity,
    pairwise_cosine,
    pairwise_dot,
    pairwise_euclidean,
)
from ruvector_tpu_torch.ops.segment import (
    masked_softmax,
    masked_weighted_mean,
    sddmm_csr,
    sddmm_padded,
    segment_softmax_csr,
    spmm_csr,
    spmm_padded,
)
from ruvector_tpu_torch.ops.spmm_bucketed import BucketPlan, build_bucket_plan, spmm_bucketed

__all__ = ["BucketPlan", "build_bucket_plan", "cosine_similarity", "masked_softmax",
           "masked_weighted_mean", "pairwise_cosine", "pairwise_dot", "pairwise_euclidean",
           "sddmm_csr", "sddmm_padded", "segment_softmax_csr", "spmm_bucketed", "spmm_csr",
           "spmm_padded"]
