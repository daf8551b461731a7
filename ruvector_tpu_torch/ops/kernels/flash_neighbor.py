"""Online-softmax attention over per-query key sets (K8): wrapper of
csrc/flash_neighbor.cu and its plain PyTorch version.

Port of ruvector_tpu/ops/pallas/flash_neighbor.py:69 flash_neighbor_attention:

    s[b, m]  = <q[b], k[b, m]> / sqrt(D)            (mask <= 0: left out)
    out[b]   = sum_m p[b, m] v[b, m] / l[b],  p = exp(s - max), l = sum_m p

with l <= 1e-8 dividing by 1, so a fully masked row gives 0. The TPU
kernel's `tile_b`/`block_m` tile its sequential grid and have no
counterpart here.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.ops.kernels import _lib

NEG = -1e30
WIDTHS = (32, 64, 128, 256)


def flash_neighbor_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: out [B, D] float32."""
    b, m, d = k.shape
    if m == 0:
        return torch.zeros((b, v.shape[-1]), dtype=torch.float32, device=q.device)
    scores = torch.einsum("bd,bmd->bm", q, k) * (1.0 / d ** 0.5)
    if mask is None:
        p = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    else:
        valid = mask > 0
        s = torch.where(valid, scores, torch.full_like(scores, NEG))
        p = torch.where(valid, torch.exp(s - torch.amax(s, dim=-1, keepdim=True)),
                        torch.zeros_like(s))
    l = torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bm,bmd->bd", p, v) / torch.where(l > 1e-8, l, torch.ones_like(l))


def flash_neighbor_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             mask: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, D], k and v [B, M, D] float32 or bfloat16 (bf16 is widened to
    float32 for the float32 kernel), mask [B, M] of any dtype or None
    (every key valid; a key counts where mask > 0, as the JAX function
    casts the mask to float32), contiguous, D in WIDTHS -> out [B, D]
    float32. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    q, k, v = (t.float() if t.dtype == torch.bfloat16 else t for t in (q, k, v))
    if mask is not None:
        mask = mask.to(torch.float32)
    if q.device.type == "cpu":
        return flash_neighbor_attention_reference(q, k, v, mask)
    args = (q, k, v) if mask is None else (q, k, v, mask)
    _lib.require(q.device.type == "cuda", f"unsupported device {q.device}")
    _lib.require(all(t.device == q.device for t in args), "inputs on different devices")
    _lib.require(all(t.dtype == torch.float32 for t in args),
                 "q, k and v must be float32 or bfloat16")
    _lib.require(all(t.is_contiguous() for t in args), "inputs must be contiguous")
    _lib.require(k.dim() == 3 and tuple(v.shape) == tuple(k.shape)
                 and tuple(q.shape) == (k.shape[0], k.shape[2])
                 and (mask is None or tuple(mask.shape) == tuple(k.shape[:2])),
                 "shape mismatch")
    b, m, d = k.shape
    _lib.require(d in WIDTHS, f"feature width must be one of {WIDTHS}, got {d}")
    _lib.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)), "inputs must be 16-byte aligned")
    out = torch.empty((b, d), dtype=torch.float32, device=q.device)
    if b == 0:
        return out
    lib = _lib.load("flash_neighbor")
    rc = lib.flash_neighbor_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                None if mask is None else mask.data_ptr(), out.data_ptr(),
                                b, m, d, 1.0 / d ** 0.5, _lib.stream_handle(q))
    flash_neighbor_attention.launches += 1
    _lib.check(lib, rc, "flash_neighbor_attention")
    return out


flash_neighbor_attention.launches = 0
