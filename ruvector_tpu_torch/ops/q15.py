"""Q15 fixed-point batch ops, the reference's wire format (port of
ruvector_tpu/ops/q15.py; reference ruvector-mincut-gated-transformer
src/q15.rs): int16 with 15 fractional bits, range [-1, 1).

Integer results equal the JAX package's bit for bit, including its
wrapping int32 accumulation: a dot or matmul sum that leaves the int32
range wraps modulo 2^32 (XLA's integer add), and so does adding the
rounding constant. torch has no integer matmul on CUDA, so q15_matmul
sums in float64, exact for these products (|a b| <= 2^30) over up to
2^22 terms a pass, then wraps the exact sum to int32.
"""

from __future__ import annotations

import torch

Q15_ONE = 32768
Q15_MAX = 32767
Q15_MIN = -32768
_EXACT_TERMS = 1 << 22      # float64 sums of |a b| <= 2^30 stay below 2^53


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value of x modulo 2^32 (two's complement), in int64."""
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def _round_q15(acc: torch.Tensor) -> torch.Tensor:
    """(acc + 2^14) >> 15 in int32 arithmetic (the add wraps), saturated."""
    return torch.clamp(_wrap32(acc + (1 << 14)) >> 15, Q15_MIN, Q15_MAX).to(torch.int16)


def f32_to_q15(x: torch.Tensor) -> torch.Tensor:
    """Saturating f32 -> Q15 (q15.rs f32_to_q15_batch)."""
    return torch.clamp(torch.round(x * Q15_ONE), Q15_MIN, Q15_MAX).to(torch.int16)


def q15_to_f32(x: torch.Tensor) -> torch.Tensor:
    return x.float() / Q15_ONE


def q15_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating Q15 add (q15_batch_add)."""
    return torch.clamp(a.to(torch.int32) + b.to(torch.int32), Q15_MIN, Q15_MAX).to(torch.int16)


def q15_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Q15 multiply with rounding, (a b + 2^14) >> 15 (q15_batch_mul)."""
    return _round_q15(a.to(torch.int64) * b.to(torch.int64))


def q15_lerp(a: torch.Tensor, b: torch.Tensor, t_q15: torch.Tensor) -> torch.Tensor:
    """a + t (b - a) in Q15 (q15_batch_lerp)."""
    diff = b.to(torch.int64) - a.to(torch.int64)
    delta = _wrap32(diff * t_q15.to(torch.int64) + (1 << 14)) >> 15
    return torch.clamp(a.to(torch.int64) + delta, Q15_MIN, Q15_MAX).to(torch.int16)


def q15_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Q15 dot product over the last axis, int32 accumulation (wrapping),
    to a Q15 value (q15_dot). An integer sum has no reassociation
    variance, so the int64 sum wrapped once is XLA's int32 sum."""
    acc = torch.sum(a.to(torch.int64) * b.to(torch.int64), dim=-1)
    return _round_q15(_wrap32(acc))


def q15_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] x [K, N] Q15 matmul, int32 accumulation (wrapping), Q15 out."""
    k = a.shape[-1]
    acc = None
    for lo in range(0, k, _EXACT_TERMS):
        part = torch.matmul(a[..., lo:lo + _EXACT_TERMS].to(torch.float64),
                            b[lo:lo + _EXACT_TERMS].to(torch.float64)).to(torch.int64)
        acc = part if acc is None else acc + part
    return _round_q15(_wrap32(acc))
