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
the batched plain gate; the kernel's blocks take partitions one at a
time from a counter, and each stops its partition when that partition
stops.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.ops.kernels import _lib
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (
    DMMA_MAX_B,
    check_rows,
    keep_words,
    layer_norm_rows,
    matmul_f64,
    pack_keep,
    persistent_grid,
)

# one block per SM: the tensor-core logits hold 210 KB of shared memory
# (bf16 rows, A_sig^T and the warps' QS strips), block_gemm's logits
# 254 registers a thread
GATE_CTAS_PER_SM = 1
# the instance's test-only variants (Variant, csrc/mincut_gate_block.cu),
# built for the tensor-core body at D = 128 on float32 x only: "probe"
# records each partition's phase cycles; "reach_one_frontier" is a fault
# (the cut's reachability stopped after its first frontier) that the card
# tests and chip_smoke.py's controls must reject
GATE_VARIANTS = {"exact": 0, "probe": 1, "reach_one_frontier": 2}
# the probe's phases (Phase, csrc/mincut_gate_block.cu): cycles of each;
# the BFS sweeps of the global relabels and of the cut; the cycles of the
# push rounds' parts (the push pass, the apply pass with the column sums,
# the relabel phase)
PROBE_PHASES = ("logits", "init", "rounds", "relabel", "cut", "keep", "relabel_sweeps",
                "cut_sweeps", "push", "apply", "heights")


def gate_body(b: int, compute_bf16: bool, ln) -> str:
    """Which logits K7 computes for a partition of b rows: "tensor_core"
    (bf16 compute with LN1 folded in, so that the rows are bf16 values,
    and b <= DMMA_MAX_B: the float64 tensor cores, the rows in shared
    memory) or "block_gemm" (float32 rows, or b in (256, 512]). The flow
    and the cut are the same in both."""
    return ("tensor_core" if compute_bf16 and ln is not None and b <= DMMA_MAX_B
            else "block_gemm")


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


def two_hop_sink(k: int, b: int, d: int, a_scale: float, eps: float = 0.01,
                 seed: int = 0):
    """Partitions on which the gate applies a cut whose source side is
    reached from s = 0 only in two hops (for checks of the cut's
    reachability). Rows are combinations of four zero-mean unit vectors
    e0..e3 on disjoint quarters of the D columns, so LayerNorm with gamma =
    1, beta = 0 keeps their directions and the pooled logits under
    A_sig = a_scale * I are a_scale * D * cos: s = e0; the first half
    (after s) e0 + c e1; the rest but the sink e1 + c' e3, orthogonal to
    s; the sink e2 + tau e0, whose logits to the first half are about 1.5
    eps and 0 to the rest. The flow (about 1.5 eps per first-half node)
    stays under half the mean positive logit, so the cut applies, and the
    second half joins s's side only through the first. Returns x [K, B, D]
    float32."""
    g = torch.Generator().manual_seed(seed)
    q = d // 4
    e = torch.zeros(4, d)
    for i in range(4):
        e[i, i * q:(i + 1) * q] = torch.tensor([1.0, -1.0]).repeat(q // 2) / q ** 0.5
    half = b // 2
    x = torch.empty(k, b, d)
    c = 0.5 + torch.rand(k, b, 1, generator=g)
    x[:, 0] = e[0]
    x[:, 1:half] = e[0] + c[:, 1:half] * e[1]
    x[:, half:b - 1] = e[1] + 0.5 * c[:, half:b - 1] * e[3]
    tau = 1.5 * eps * 1.5 / (a_scale * d)
    x[:, b - 1] = e[2] + tau * e[0]
    return x


def gate_from_logits(lg, *, lam: float, eps: float):
    """The batched plain gate on [K, B, B] logits, in K7's output format:
    (keep [K, B/32, B] int32 words, stats [K, 8, B] float32 with rows 0..3
    = cut cost (0 if not applied), flow, applied flag, push-relabel
    rounds)."""
    # imported here: the attention package imports the training package,
    # which imports the layers that import these kernels
    from ruvector_tpu_torch.attention.mincut_device import mincut_gate_stats

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
                             compute_bf16: bool = False, variant: str = "exact"):
    """Solve K partitions' pooled-logit min-cut gates.

    x [K, B, D] (float32 or bfloat16; the math is float32), pad [K, B]
    float32, A_sig [D, D] float32, ln optional (gamma [D], beta [D]) to
    fold LN1 in. B must be a multiple of 32. Returns (keep [K, B/32, B]
    int32 words, stats [K, 8, B] float32), as the plain version. CPU
    tensors take the plain version; CUDA tensors launch the kernel.

    `variant` is for measurement and controls only (GATE_VARIANTS): "probe"
    also returns int64 [K, 11] per-partition cycles of each phase and the
    BFS sweeps (PROBE_PHASES) as a third output; "reach_one_frontier" runs
    a planted fault.
    """
    name = "mincut_gate_block_from_x"
    _lib.require(variant in GATE_VARIANTS, f"{name}: unknown variant {variant!r}")
    if x.device.type == "cpu":
        _lib.require(variant == "exact", f"{name}: variant {variant!r} runs on the card only")
        return mincut_gate_block_from_x_reference(x, pad, A_sig, lam=lam, eps=eps, ln=ln,
                                                  compute_bf16=compute_bf16)
    check_rows(name, x, pad, () if ln is None else ln, (A_sig,))
    k, b, d = x.shape
    _lib.require(b % 32 == 0, f"block size {b} must be a multiple of 32")
    tc = gate_body(b, compute_bf16, ln) == "tensor_core"
    _lib.require(variant == "exact" or (tc and d == 128 and x.dtype == torch.float32),
                 f"{name}: variant {variant!r} is built for the tensor-core body at D=128 "
                 f"on float32 x only")
    keep = torch.empty((k, keep_words(b), b), dtype=torch.int32, device=x.device)
    stats = torch.empty((k, 8, b), dtype=torch.float32, device=x.device)
    probe = (torch.zeros((k, len(PROBE_PHASES)), dtype=torch.int64, device=x.device)
             if variant == "probe" else None)
    if k == 0:
        return (keep, stats) if probe is None else (keep, stats, probe)
    grid = persistent_grid(x.device, k, GATE_CTAS_PER_SM)
    # per CTA: C, R and P [B, B], and block_gemm's X and QS [B, D]
    scratch = torch.empty(grid * (3 * b * b + (0 if tc else 2 * b * d)), dtype=torch.float32,
                          device=x.device)
    counter = torch.zeros(1, dtype=torch.int32, device=x.device)
    lib = _lib.load("mincut_gate_block")
    rc = lib.mincut_gate_block_from_x(
        x.data_ptr(), pad.data_ptr(), A_sig.data_ptr(),
        None if ln is None else ln[0].data_ptr(), None if ln is None else ln[1].data_ptr(),
        keep.data_ptr(), stats.data_ptr(), scratch.data_ptr(),
        None if probe is None else probe.data_ptr(), counter.data_ptr(), k, b, d, grid,
        int(x.dtype == torch.bfloat16), int(compute_bf16), int(tc), GATE_VARIANTS[variant],
        float(lam), float(eps), _lib.stream_handle(x))
    mincut_gate_block_from_x.launches += 1
    _lib.check(lib, rc, name)
    return (keep, stats) if probe is None else (keep, stats, probe)


mincut_gate_block_from_x.launches = 0
