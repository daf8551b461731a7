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

The kernel works in tiles of consecutive output rows whose indices and
weights it stages in shared memory; a tile whose valid indices span a
window of feature rows that fits WINDOW_BYTES stages that window too and
gathers from it ("staged"), the others gather from device memory.
`rows_per_tile` and `staged_tiles` give the kernel's tiling and its share
of staged tiles from the indices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ruvector_tpu_torch.ops.kernels import _lib
from ruvector_tpu_torch.ops.segment import spmm_padded

MAX_D = 512
# csrc/spmm_gather.cu's tiling: edges staged at once, rows a tile at most,
# and the bytes of feature rows a tile may stage
TILE_EDGES, MAX_ROWS, WINDOW_BYTES = 2048, 128, 64 * 1024
# K9's test-only variant (built at D = 128 only), a fault that the card
# tests and chip_smoke.py's controls must reject: edge M-1 of every row
# left out of its sum
K9_VARIANTS = {"exact": 0, "drop_last_edge": 1}


def rows_per_tile(m: int) -> int:
    """Output rows of one tile for m edges a row: as many as TILE_EDGES
    edges hold, 1..MAX_ROWS (a row of more edges goes in batches of
    TILE_EDGES)."""
    return MAX_ROWS if m <= 0 else max(1, min(MAX_ROWS, TILE_EDGES // m))


def staged_tiles(nbr_idx: torch.Tensor, n: int, d: int) -> float:
    """Share of the kernel's tiles (batches of a tile's edges: one a tile,
    several for a row of more than TILE_EDGES edges) whose indices in
    [0, n) span a window of at most WINDOW_BYTES of feature rows of width
    d, the tiles that gather from shared memory. 0 where there is no
    edge."""
    b, m = nbr_idx.shape
    if b == 0 or m == 0:
        return 0.0
    r = rows_per_tile(m)
    idx = nbr_idx.long()
    if r > 1:  # one batch a tile; missing rows of the last add nothing
        idx = F.pad(idx, (0, 0, 0, -b % r), value=-1).reshape(-1, r * m)
    else:      # one row a tile, its edges in batches of TILE_EDGES
        idx = F.pad(idx, (0, -m % TILE_EDGES), value=-1).reshape(-1, TILE_EDGES)
    valid = (idx >= 0) & (idx < n)
    lo = torch.where(valid, idx, torch.full_like(idx, n)).amin(dim=1)
    hi = torch.where(valid, idx, torch.full_like(idx, -1)).amax(dim=1)
    fits = (hi >= lo) & ((hi - lo + 1) * d * 4 <= WINDOW_BYTES)
    return float(fits.float().mean())


def spmm_gather_reference(features: torch.Tensor, nbr_idx: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: `spmm_padded` with an index
    outside [0, N) clamped into range and masked out. [B, D] float32."""
    n = features.shape[0]
    valid = (nbr_idx >= 0) & (nbr_idx < n)
    return spmm_padded(features, nbr_idx.clamp(0, n - 1), weights, valid.to(weights.dtype))


def spmm_gather(features: torch.Tensor, nbr_idx: torch.Tensor,
                weights: torch.Tensor, variant: str = "exact") -> torch.Tensor:
    """features [N, D] float32, nbr_idx [B, M] int32, weights [B, M]
    float32 (weight * mask), all contiguous -> out [B, D] float32. CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    `variant` other than "exact" runs a fault planted in the kernel
    (K9_VARIANTS), for controls only."""
    name = "spmm_gather"
    _lib.require(variant in K9_VARIANTS, f"{name}: unknown variant {variant!r}")
    if features.device.type == "cpu":
        _lib.require(variant == "exact", f"{name}: variant {variant!r} runs on the card only")
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
    _lib.require(variant == "exact" or d == 128,
                 f"{name}: variant {variant!r} is built at D=128 only")
    out = torch.empty((b, d), dtype=torch.float32, device=features.device)
    if b == 0:
        return out
    lib = _lib.load("spmm_gather")
    rc = lib.spmm_gather_f32(features.data_ptr(), nbr_idx.data_ptr(), weights.data_ptr(),
                             out.data_ptr(), n, b, m, d, K9_VARIANTS[variant],
                             _lib.stream_handle(features))
    spmm_gather.launches += 1
    _lib.check(lib, rc, name)
    return out


spmm_gather.launches = 0
