"""Batched min-cut gate per partition (K7): wrapper of
csrc/mincut_gate_block.cu and its plain PyTorch version.

Port of ruvector_tpu/ops/pallas/mincut_gate_block.py:234
mincut_gate_block_from_x. Per partition: the pooled logits
(X A_sig) X^T from the features (LN1 folded in when `ln` is given, the
normalised features rounded to bf16 in bf16 compute mode; the logit
products themselves are float32 with a float32 A_sig, their sums float64
rounded once to float32, as in the kernel), -1.0 on padding,
then the push-relabel gate of attention/mincut_device and the bit-packed
keep mask. The plain version runs all K partitions lock-stepped through
the batched plain gate; the kernel solves each partition in its own
block of threads and stops when that partition stops.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.attention.mincut_device import mincut_gate_stats
from ruvector_tpu_torch.ops.kernels import _lib
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (
    check_rows,
    keep_words,
    layer_norm_rows,
    matmul_f64,
    pack_keep,
    persistent_grid,
)

GATE_CTAS_PER_SM = 1


def pooled_logits_from_x(x, pad, A_sig, ln=None, compute_bf16: bool = False):
    """The gate's [K, B, B] float32 logits, -1.0 on padding pairs."""
    X = x.float()
    if ln is not None:
        X = layer_norm_rows(X, ln[0].float(), ln[1].float())
        if compute_bf16:
            X = X.to(torch.bfloat16).float()
    lg = matmul_f64(matmul_f64(X, A_sig.float()), X.transpose(1, 2))
    padf = pad.float()
    valid = padf[:, :, None] * padf[:, None, :]
    return torch.where(valid > 0, lg, torch.full_like(lg, -1.0))


def isolated_sink(x, a_scale: float, eps: float = 0.01):
    """Partitions on which the gate applies a cut (for agreement checks of
    the kernel). Every row lies near the partition's first row, scaled so
    that the pooled logits under A_sig = a_scale * I are about a_scale * D;
    the last row (the sink, t = B-1) is the first row scaled so that its
    logits are about 1.15 eps, just above the clamp. The flow into the
    sink, about 1.15 eps B, then stays under half the mean positive logit
    (for B up to 256 at D = 128, a_scale = 0.1). x [K, B, D] -> a new
    tensor."""
    x = x[:, :1] + 0.3 * x
    norm0 = torch.linalg.vector_norm(x[:, 0], dim=-1)
    x = x * (1.3 * x.shape[-1] ** 0.5 / norm0)[:, None, None]
    x0 = x[:, 0]
    x[:, -1] = x0 * (1.5 * eps / (a_scale * (x0 * x0).sum(-1, keepdim=True)))
    return x


def gate_from_logits(lg, *, lam: float, eps: float):
    """The batched plain gate on [K, B, B] logits, in K7's output format:
    (keep [K, B/32, B] int32 words, stats [K, 8, B] float32 with rows 0..3
    = cut cost (0 if not applied), flow, applied flag, push-relabel
    rounds)."""
    k, b, _ = lg.shape
    keep, cost, flow, applied, rounds = mincut_gate_stats(lg, lam, eps)
    stats = torch.zeros((k, 8, b), dtype=torch.float32, device=lg.device)
    for row, v in enumerate((cost, flow, applied.float(), rounds.float())):
        stats[:, row, :] = v.float()[:, None]
    return pack_keep(keep), stats


def mincut_gate_block_from_x_reference(x, pad, A_sig, *, lam: float, eps: float, ln=None,
                                       compute_bf16: bool = False):
    """Plain PyTorch version of K7: gate_from_logits of the pooled logits."""
    return gate_from_logits(pooled_logits_from_x(x, pad, A_sig, ln, compute_bf16),
                            lam=lam, eps=eps)


def mincut_gate_block_from_x(x, pad, A_sig, *, lam: float, eps: float, ln=None,
                             compute_bf16: bool = False):
    """Solve K partitions' pooled-logit min-cut gates.

    x [K, B, D] (float32 or bfloat16; the math is float32), pad [K, B]
    float32, A_sig [D, D] float32, ln optional (gamma [D], beta [D]) to
    fold LN1 in. B must be a multiple of 32. Returns (keep [K, B/32, B]
    int32 words, stats [K, 8, B] float32), as the plain version. CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    if x.device.type == "cpu":
        return mincut_gate_block_from_x_reference(x, pad, A_sig, lam=lam, eps=eps, ln=ln,
                                                  compute_bf16=compute_bf16)
    check_rows("mincut_gate_block_from_x", x, pad, () if ln is None else ln, (A_sig,))
    k, b, d = x.shape
    _lib.require(b % 32 == 0, f"block size {b} must be a multiple of 32")
    keep = torch.empty((k, keep_words(b), b), dtype=torch.int32, device=x.device)
    stats = torch.empty((k, 8, b), dtype=torch.float32, device=x.device)
    if k == 0:
        return keep, stats
    grid = persistent_grid(x.device, k, GATE_CTAS_PER_SM)
    scratch = torch.empty(grid * (2 * b * d + 3 * b * b), dtype=torch.float32,
                          device=x.device)
    lib = _lib.load("mincut_gate_block")
    rc = lib.mincut_gate_block_from_x(
        x.data_ptr(), pad.data_ptr(), A_sig.data_ptr(),
        None if ln is None else ln[0].data_ptr(), None if ln is None else ln[1].data_ptr(),
        keep.data_ptr(), stats.data_ptr(), scratch.data_ptr(), k, b, d, grid,
        int(x.dtype == torch.bfloat16), int(compute_bf16), float(lam), float(eps),
        _lib.stream_handle(x))
    mincut_gate_block_from_x.launches += 1
    _lib.check(lib, rc, "mincut_gate_block_from_x")
    return keep, stats


mincut_gate_block_from_x.launches = 0
