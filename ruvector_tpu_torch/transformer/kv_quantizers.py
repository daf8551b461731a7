"""Named KV-cache quantizers: KVQuant (pre-RoPE keys) and SQuat
(subspace-orthogonal), complementing the KIVI scheme in kv_cache.py (port
of ruvector_tpu/transformer/kv_quantizers.py).

Reference: ruvector-mincut-gated-transformer/src/kv_cache/ —
kvquant.rs: quantize keys BEFORE RoPE (pre-RoPE keys have smaller dynamic
range; RoPE is applied lazily at attention time), 3-bit keys, values
uniform or non-uniform with outlier bins; squat.rs: project KV onto
orthogonal subspaces (decorrelation), quantize each subspace with its own
scale/zero-point.

Quantized payloads live as int8 tensors (one value per component; the
3-bit/4-bit width shows up in the level count). The reference calls these
functions outside any compiled program, so their divisions by a constant
are true divisions (`true_div`), rounded alike on the CPU and on CUDA.
"""

from __future__ import annotations

import dataclasses

import torch

from ruvector_tpu_torch.attention.rope import rope_rotate
from ruvector_tpu_torch.attention.sheaf import quantile
from ruvector_tpu_torch.ops.quantization import true_div


# --------------------------------------------------------------------------
# KVQuant (kvquant.rs)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class KVQuantized:
    q: torch.Tensor         # int8 codes in [-(2^(b-1)), 2^(b-1)-1]
    scale: torch.Tensor     # per-channel scales [d]
    bits: int
    pre_rope: bool


def kvquant_quantize_keys(keys: torch.Tensor, bits: int = 3,
                          pre_rope: bool = True) -> KVQuantized:
    """Per-channel symmetric quantization of keys [t, d]. Call on PRE-RoPE
    keys (kvquant.rs PreRoPE mode): their per-channel dynamic range is
    narrower, so the same bit budget loses less."""
    qmax = (1 << (bits - 1)) - 1
    scale = true_div(torch.clamp(torch.amax(torch.abs(keys), dim=0), min=1e-8), float(qmax))
    q = torch.clamp(torch.round(keys / scale), -qmax - 1, qmax).to(torch.int8)
    return KVQuantized(q=q, scale=scale, bits=bits, pre_rope=pre_rope)


def kvquant_dequantize_keys(kq: KVQuantized) -> torch.Tensor:
    return kq.q.to(torch.float32) * kq.scale


def kvquant_attention_scores(query_rotated, kq: KVQuantized, cos_t, sin_t, positions):
    """Scores against a pre-RoPE-quantized key cache: dequantize, THEN
    apply RoPE at the keys' stored positions (deferred rotation,
    kvquant.rs 'Apply RoPE during attention')."""
    keys = kvquant_dequantize_keys(kq)
    keys_rot = rope_rotate(keys, positions, cos_t, sin_t)
    d = keys.shape[-1]
    return (keys_rot @ query_rotated) / torch.sqrt(
        torch.tensor(float(d), device=keys.device))


@dataclasses.dataclass
class NonUniformValues:
    q: torch.Tensor             # int8 codes for inliers
    scale: torch.Tensor         # per-token scales [t]
    outlier_mask: torch.Tensor  # [t, d] bool
    outlier_vals: torch.Tensor  # [t, d] f32 (zeros where not outlier)
    bits: int


def kvquant_quantize_values(values: torch.Tensor, bits: int = 4,
                            outlier_percentile: float = 99.0) -> NonUniformValues:
    """Non-uniform value quantization (kvquant.rs NonUniform): the top
    |v| percentile stays exact f32; the rest is per-token uniform."""
    # jnp.percentile divides q by 100 in float32, then takes the linear quantile
    q_frac = float(true_div(torch.tensor(outlier_percentile), 100.0))
    thresh = quantile(torch.abs(values), q_frac)
    mask = torch.abs(values) > thresh
    inliers = torch.where(mask, 0.0, values)
    qmax = (1 << (bits - 1)) - 1
    scale = true_div(torch.clamp(torch.amax(torch.abs(inliers), dim=-1), min=1e-8), float(qmax))
    q = torch.clamp(torch.round(inliers / scale[:, None]), -qmax - 1, qmax).to(torch.int8)
    return NonUniformValues(q=q, scale=scale, outlier_mask=mask,
                            outlier_vals=torch.where(mask, values, 0.0), bits=bits)


def kvquant_dequantize_values(nv: NonUniformValues) -> torch.Tensor:
    dec = nv.q.to(torch.float32) * nv.scale[:, None]
    return torch.where(nv.outlier_mask, nv.outlier_vals, dec)


# --------------------------------------------------------------------------
# SQuat (squat.rs)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SQuatBasis:
    basis: torch.Tensor     # [d, d] orthogonal (columns = directions)
    num_subspaces: int
    bits: int


@dataclasses.dataclass
class SQuatCompressed:
    codes: torch.Tensor     # int8 [t, d] (per-subspace-quantized coords)
    scales: torch.Tensor    # [num_subspaces]
    zeros: torch.Tensor     # [num_subspaces]


def squat_learn_basis(calibration: torch.Tensor, num_subspaces: int = 4,
                      bits: int = 4) -> SQuatBasis:
    """Orthogonal basis from the calibration covariance eigenvectors —
    decorrelates components so each subspace quantizes tighter (squat.rs
    'learned orthogonal bases'). Eigenvectors come in ascending eigenvalue
    order; their signs, and the basis of a repeated eigenvalue, are
    arbitrary (another eigensolver may return other ones)."""
    x = calibration - torch.mean(calibration, dim=0)
    cov = true_div(x.T @ x, float(x.shape[0]))
    _, vecs = torch.linalg.eigh(cov)
    return SQuatBasis(basis=vecs, num_subspaces=num_subspaces, bits=bits)


def squat_quantize(kv: torch.Tensor, basis: SQuatBasis) -> SQuatCompressed:
    """Project [t, d] onto the orthogonal basis, quantize each contiguous
    subspace with its own scale/zero-point (squat.rs quantize :256)."""
    t, d = kv.shape
    ns = basis.num_subspaces
    proj = kv @ basis.basis                       # decorrelated coords
    sub = proj.reshape(t, ns, d // ns)
    lo = torch.amin(sub, dim=(0, 2))
    hi = torch.amax(sub, dim=(0, 2))
    levels = (1 << basis.bits) - 1
    scale = true_div(torch.clamp(hi - lo, min=1e-8), float(levels))
    codes = torch.clamp(torch.round((sub - lo[None, :, None]) / scale[None, :, None]), 0, levels)
    return SQuatCompressed(codes=codes.reshape(t, d).to(torch.int8), scales=scale, zeros=lo)


def squat_dequantize(c: SQuatCompressed, basis: SQuatBasis) -> torch.Tensor:
    t, d = c.codes.shape
    ns = basis.num_subspaces
    sub = c.codes.reshape(t, ns, d // ns).to(torch.float32)
    proj = sub * c.scales[None, :, None] + c.zeros[None, :, None]
    return proj.reshape(t, d) @ basis.basis.T


def squat_compression_ratio(basis: SQuatBasis, dim: int) -> float:
    """Bytes vs FP16 (squat.rs compression_ratio), counting the packed
    bit width."""
    payload_bits = dim * basis.bits + basis.num_subspaces * 64
    return (dim * 16) / payload_bits
