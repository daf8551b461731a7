"""Int8 symmetric quantization for deterministic inference (port of
ruvector_tpu/transformer/quant.py).

Per-output-channel int8 weights, per-row int8 activations, and an int8 x
int8 product whose sums are exact integers, rescaled by the two scales.

Scales: the JAX package runs these functions inside jitted programs (the
model's tiers, the decode step), where XLA folds `absmax / 127.0` into
`absmax * float32(1 / 127)`; that product is one bit off the quotient in
about 4% of rows. The port computes the scale as that product, so that its
scales and codes equal the jitted programs' on the same input. `x / scale`
divides by a tensor, which CUDA and the CPU both round correctly (a
Python-number divisor would make CUDA multiply by its reciprocal).
"""

from __future__ import annotations

import torch


def _symmetric_int8(x: torch.Tensor, dim: int, keepdim: bool) -> tuple[torch.Tensor, torch.Tensor]:
    absmax = torch.amax(torch.abs(x), dim=dim, keepdim=keepdim)
    scale = torch.clamp(absmax, min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: returns (w_q [in,out] int8,
    scale [out] f32) with w ≈ w_q * scale."""
    return _symmetric_int8(w, 0, False)


def quantize_activation_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (token) symmetric int8 activation quantization."""
    return _symmetric_int8(x, -1, True)


def dequantize_int8(w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return w_q.to(torch.float32) * scale


def int8_sums(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x_q [.., in] @ w_q [in, out] summed exactly, as int32.

    int8 x int8 has no safe torch.matmul: on the CPU it returns int8 and
    wraps (a row of 127s times a column of 127s over K=4 gives 4, not
    64516); on CUDA integer matmul is not implemented, and torch._int_mm
    needs more than 16 rows, which the decode steps (1 to B rows) do not
    have. A float64 product is exact on both: every product and partial sum
    is an integer of magnitude at most 127^2 * in < 2^53."""
    return torch.matmul(x_q.to(torch.float64), w_q.to(torch.float64)).to(torch.int32)


def int8_matmul(
    x: torch.Tensor,          # [.., in] f32 activations
    w_q: torch.Tensor,        # [in, out] int8
    w_scale: torch.Tensor,    # [out] f32
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Quantize activations -> exact integer product -> rescale, in JAX's
    order: acc * x_scale * w_scale + bias."""
    x_q, x_scale = quantize_activation_int8(x)
    acc = int8_sums(x_q, w_q)
    out = acc.to(torch.float32) * x_scale * w_scale
    if bias is not None:
        out = out + bias
    return out
