"""Gather-fused padded SpMM (K9): wrapper of csrc/spmm_gather.cu and its
plain PyTorch version.

Port of ruvector_tpu/ops/pallas/spmm.py:34 spmm_pallas (named for what it
does: the JAX name names the TPU):

    out[i] = sum_m w[i, m] * feat[nbr[i, m]]

with the mask folded into w (0 on padding). An edge whose index lies
outside [0, N) adds nothing and its row is never read: the kernel tests
each index against N before the load, so the wrapper needs no host-side
check of the indices (which would sync with the card). The plain version
does the same.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.ops.kernels import _lib
from ruvector_tpu_torch.ops.segment import spmm_padded

MAX_D = 512


def spmm_gather_reference(features: torch.Tensor, nbr_idx: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: `spmm_padded` with an index
    outside [0, N) clamped into range and masked out. [B, D] float32."""
    n = features.shape[0]
    valid = (nbr_idx >= 0) & (nbr_idx < n)
    return spmm_padded(features, nbr_idx.clamp(0, n - 1), weights, valid.to(weights.dtype))


def spmm_gather(features: torch.Tensor, nbr_idx: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """features [N, D] float32, nbr_idx [B, M] int32, weights [B, M]
    float32 (weight * mask), all contiguous -> out [B, D] float32. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if features.device.type == "cpu":
        return spmm_gather_reference(features, nbr_idx, weights)
    args = (features, nbr_idx, weights)
    _lib.require(features.device.type == "cuda", f"unsupported device {features.device}")
    _lib.require(all(t.device == features.device for t in args), "inputs on different devices")
    _lib.require(features.dtype == torch.float32 and weights.dtype == torch.float32,
                 "features and weights must be float32")
    _lib.require(nbr_idx.dtype == torch.int32, "nbr_idx must be int32")
    _lib.require(all(t.is_contiguous() for t in args), "inputs must be contiguous")
    _lib.require(features.dim() == 2 and nbr_idx.dim() == 2
                 and tuple(weights.shape) == tuple(nbr_idx.shape), "shape mismatch")
    n, d = features.shape
    b, m = nbr_idx.shape
    _lib.require(0 < d <= MAX_D and d % 4 == 0,
                 f"feature width must be a multiple of 4 up to {MAX_D}, got {d}")
    _lib.require(features.data_ptr() % 16 == 0, "features must be 16-byte aligned")
    out = torch.empty((b, d), dtype=torch.float32, device=features.device)
    if b == 0:
        return out
    lib = _lib.load("spmm_gather")
    rc = lib.spmm_gather_f32(features.data_ptr(), nbr_idx.data_ptr(), weights.data_ptr(),
                             out.data_ptr(), n, b, m, d, _lib.stream_handle(features))
    spmm_gather.launches += 1
    _lib.check(lib, rc, "spmm_gather")
    return out


spmm_gather.launches = 0
