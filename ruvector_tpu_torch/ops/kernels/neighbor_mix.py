"""Fused neighbor attention + aggregation (K3): wrapper of
csrc/neighbor_mix.cu and its plain PyTorch version.

Port of ruvector_tpu/ops/pallas/neighbor_mix.py:68 fused_neighbor_mix:

    scores[n,h,m] = (sum_d u[n,h,d] * nbr[n,m,d] + bias[n,h]) * scale
    attn          = eps-guarded masked softmax over m
    mixed[n,h,:]  = sum_m attn[n,h,m] * nbr[n,m,:]     (h < H)
    mixed[n,H,:]  = sum_m wnorm[n,m] * nbr[n,m,:]

The kernel has two bodies chosen by shape (`k3_body`): "streaming" (a
node's rows held in registers, the scores reduced by a reduce-scatter
butterfly) where its register budget holds, "warp" elsewhere.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.ops.kernels import _lib

NEG = -1e30
HEADS = (1, 2, 4, 8, 16)
# the streaming body's limits: head counts, neighbor rows (held in
# registers), and the row width (four columns a lane, 32 lanes)
STREAM_HEADS, STREAM_MAX_SLOTS, STREAM_MAX_WIDTH = (1, 2, 4, 8), 16, 128
# K3's test-only variant of the streaming body (csrc/neighbor_mix.cu, built
# at H = 4 only), a fault that the card tests and chip_smoke.py's controls
# must reject: slot M-1 left out of every sum
K3_VARIANTS = {"exact": 0, "drop_last_slot": 1}


def k3_body(heads: int, m: int, d: int) -> str:
    """Which body of K3 runs for `heads` heads, `m` neighbor slots and
    width `d`: "streaming" at heads in STREAM_HEADS, m <= 16, d % 4 == 0
    and d <= 128 (a node's m rows fit in registers, four columns a lane),
    else "warp"."""
    fits = (heads in STREAM_HEADS and m <= STREAM_MAX_SLOTS and d % 4 == 0
            and d <= STREAM_MAX_WIDTH)
    return "streaming" if fits else "warp"


def fused_neighbor_mix_reference(u, score_bias, nbr_msg, mask, wnorm, heads: int,
                                 scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: mixed [N, H+1, D] float32."""
    valid = (mask > 0)[:, None, :]
    scores = (torch.einsum("nhd,nmd->nhm", u, nbr_msg) + score_bias[:, :, None]) * scale
    scores = torch.where(valid, scores, torch.full_like(scores, NEG))
    m_max = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(scores - m_max), torch.zeros_like(scores))
    attn = e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-10)
    allw = torch.cat([attn, wnorm[:, None, :]], dim=1)
    return torch.einsum("nhm,nmd->nhd", allw, nbr_msg)


def fused_neighbor_mix(u, score_bias, nbr_msg, mask, wnorm, heads: int,
                       scale: float, variant: str = "exact") -> torch.Tensor:
    """u [N,H,D], score_bias [N,H], nbr_msg [N,M,D], mask and wnorm [N,M],
    all float32 -> mixed [N, H+1, D] float32: the H attention aggregates,
    then the weighted mean. CPU tensors take the plain version; CUDA
    tensors launch the kernel, whose body follows the shape (`k3_body`).
    `variant` other than "exact" runs a fault planted in the streaming body
    (K3_VARIANTS), for controls only."""
    name = "fused_neighbor_mix"
    _lib.require(variant in K3_VARIANTS, f"{name}: unknown variant {variant!r}")
    if u.device.type == "cpu":
        _lib.require(variant == "exact", f"{name}: variant {variant!r} runs on the card only")
        return fused_neighbor_mix_reference(u, score_bias, nbr_msg, mask, wnorm,
                                            heads, scale)
    n, m, d = nbr_msg.shape
    args = (u, score_bias, nbr_msg, mask, wnorm)
    _lib.require(u.device.type == "cuda", f"unsupported device {u.device}")
    _lib.require(all(t.device == u.device for t in args), "inputs on different devices")
    _lib.require(all(t.dtype == torch.float32 for t in args), "inputs must be float32")
    _lib.require(all(t.is_contiguous() for t in args), "inputs must be contiguous")
    _lib.require(heads in HEADS, f"heads must be one of {HEADS}, got {heads}")
    _lib.require(tuple(u.shape) == (n, heads, d) and tuple(score_bias.shape) == (n, heads)
                 and tuple(mask.shape) == (n, m) and tuple(wnorm.shape) == (n, m),
                 "shape mismatch")
    streaming = k3_body(heads, m, d) == "streaming"
    _lib.require(variant == "exact" or (streaming and heads == 4 and m >= 1),
                 f"{name}: variant {variant!r} is built for the streaming body at H=4 only")
    if streaming:  # float4 rows: a view that starts off 16 bytes is copied
        u, nbr_msg = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (u, nbr_msg))
    out = torch.empty((n, heads + 1, d), dtype=torch.float32, device=u.device)
    if n == 0:
        return out
    lib = _lib.load("neighbor_mix")
    rc = lib.neighbor_mix_f32(
        u.data_ptr(), score_bias.data_ptr(), nbr_msg.data_ptr(), mask.data_ptr(),
        wnorm.data_ptr(), out.data_ptr(), n, heads, m, d, int(streaming),
        K3_VARIANTS[variant], scale, _lib.stream_handle(u))
    fused_neighbor_mix.launches += 1
    _lib.check(lib, rc, name)
    return out


fused_neighbor_mix.launches = 0
