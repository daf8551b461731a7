#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (ruvector_tpu_torch).

Builds the CUDA kernels from `ruvector_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version, then drives the port's paths on one
card:

  * the RuvectorLayer at the bench's headline width: a clustered
    100k-node, 128-d feature set (bench.py's data, seed 0), its k=16
    cosine kNN graph built on the card, graph-grown 512-node blocks, and
    the block-dense layer (d=128, 4 heads, bf16 compute) as the fused
    kernel, applied a few times to its own output. The other kernel
    routes (block-dense attention, slot neighbor-mix) and the 2-layer
    RuvectorNet run on the same graph.
  * the min-cut-gated graph transformer's serving path (BASELINE config
    5, benchmarks/config5_r03.py): 999,936 nodes in clusters of 128 with
    exact within-cluster k=16 kNN made on the card, 256-node partitions
    (3906, halo-free), d=128, 4 heads, FFN x4, 2 layers, bf16 compute,
    random weights from seed 0. gate_state_init solves every gate; then
    steady steps (the same input: every gate reused) and drift steps
    (features moved by 0.1 N(0,1) each step: budget-capped re-solves).
  * config 5's train step on the same graph, weights and masks
    (config5_r03.py:204-226: the loss against zero targets under the
    state's masks, its gradient, then w - 1e-3 g; remat, bf16 compute),
    with the kernel route's gradients held against the plain route's on
    the first 244 partitions.
  * config 5's layers on a layout with a halo (120,000 nodes, 240-node
    partitions, B % 32 != 0): init, steady and drift steps and one train
    step, against the plain route.
  * the RuvectorLayer's contrastive train step (Adam) on the 100k-node
    graph.

Prints one line per phase, the card's name and power limit, a `kernels`
JSON line (launches on the main paths, error against the plain version,
times on the card, the least time the card could take), and as the last
line `{"ok": true, "device": {...}}`. Any failed phase exits non-zero
before that line; so does a run without a CUDA card or without the
package beside this script.

    python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ruvector_tpu_torch.graph import build_block_dense, build_knn_graph  # noqa: E402
from ruvector_tpu_torch.graph_transformer import gated  # noqa: E402
from ruvector_tpu_torch.models import (  # noqa: E402
    RuvectorNetConfig,
    ruvector_net_apply,
    ruvector_net_init,
)
from ruvector_tpu_torch.nn.block_dense_layer import (  # noqa: E402
    fold_layer_params,
    ruvector_layer_apply_block_dense,
    ruvector_layer_apply_block_dense_fused,
)
from ruvector_tpu_torch.nn.core import linear_apply  # noqa: E402
from ruvector_tpu_torch.nn.ruvector_layer import (  # noqa: E402
    RuvectorLayerConfig,
    ruvector_layer_apply,
    ruvector_layer_init,
)
from ruvector_tpu_torch.ops import kernels  # noqa: E402
from ruvector_tpu_torch.ops.kernels import _lib  # noqa: E402
from ruvector_tpu_torch.ops.kernels.block_dense_attn import (  # noqa: E402
    block_dense_attention,
    block_dense_attention_reference,
    block_dense_layer_fused,
    block_dense_layer_fused_reference,
)
from ruvector_tpu_torch.ops.kernels.gated_block_attn import (  # noqa: E402
    as_cdt,
    block_gate_signature,
    block_gate_signature_ln_x,
    block_gate_signature_ln_x_reference,
    block_gate_signature_reference,
    block_gate_signature_x,
    block_gate_signature_x_reference,
    fold_gated_attention_params,
    gated_block_attention_bwd,
    gated_block_attention_bwd_partials,
    gated_block_attention_bwd_reference,
    gated_block_attention_fwd,
    gated_block_attention_fwd_reference,
    head_concat,
    layer_norm_rows,
    matmul_f64,
    pack_keep,
    reduce_partials,
    unpack_keep,
)
from ruvector_tpu_torch.ops.kernels.gated_block_layer import (  # noqa: E402
    fold_gated_layer_params,
    gated_block_layer,
    gated_block_layer_reference,
    gated_block_layer_with_sig,
    gated_block_layer_with_sig_reference,
)
from ruvector_tpu_torch.ops.kernels.mincut_gate_block import (  # noqa: E402
    gate_from_logits,
    isolated_sink,
    mincut_gate_block_from_x,
    mincut_gate_block_from_x_reference,
)
from ruvector_tpu_torch.ops.kernels.neighbor_mix import (  # noqa: E402
    fused_neighbor_mix,
    fused_neighbor_mix_reference,
)
from ruvector_tpu_torch.ops.segment import normalized_weights  # noqa: E402
from ruvector_tpu_torch.parallel.ordering import graph_grow_blocks  # noqa: E402
from ruvector_tpu_torch.training import (  # noqa: E402
    TrainConfig,
    adam,
    make_train_step,
    sample_negatives,
)

DEV = torch.device("cuda")
N_NODES = 100_000   # bench.py's headline graph
ITERS = 3           # layer applications on the main path, each on its own output
# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# tolerances against the plain versions on the same inputs. f32: sums of
# up to T=1024 products in another order, on outputs of order 1.
# bf16: the kernels round the softmax weights relative to a running max
# (online softmax over streamed chunks) where the plain version rounds
# them relative to the row max; a weight of relative size 2^-9 may round
# the other way, so outputs of order 1 move by up to a few 1e-3.
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (5e-2, 5e-3)}   # (max, mean)
SOURCES = {
    "block_dense_layer_fused": ("ruvector_tpu_torch/csrc/block_dense_attn.cu",
                                "ruvector_tpu/ops/pallas/block_dense_attn.py:246"),
    "block_dense_attention": ("ruvector_tpu_torch/csrc/block_dense_attn.cu",
                              "ruvector_tpu/ops/pallas/block_dense_attn.py:81"),
    "fused_neighbor_mix": ("ruvector_tpu_torch/csrc/neighbor_mix.cu",
                           "ruvector_tpu/ops/pallas/neighbor_mix.py:68"),
    "gated_block_layer": ("ruvector_tpu_torch/csrc/gated_block_layer.cu",
                          "ruvector_tpu/ops/pallas/gated_block_layer.py:195"),
    "gated_block_layer_with_sig": ("ruvector_tpu_torch/csrc/gated_block_layer.cu",
                                   "ruvector_tpu/ops/pallas/gated_block_layer.py:251"),
    "block_gate_signature_ln_x": ("ruvector_tpu_torch/csrc/gated_block_attn.cu",
                                  "ruvector_tpu/ops/pallas/gated_block_attn.py:487"),
    "mincut_gate_block_from_x": ("ruvector_tpu_torch/csrc/mincut_gate_block.cu",
                                 "ruvector_tpu/ops/pallas/mincut_gate_block.py:234"),
    "gated_block_attention_fwd": ("ruvector_tpu_torch/csrc/gated_block_mha.cu",
                                  "ruvector_tpu/ops/pallas/gated_block_attn.py:119"),
    "gated_block_attention_bwd": ("ruvector_tpu_torch/csrc/gated_block_mha.cu",
                                  "ruvector_tpu/ops/pallas/gated_block_attn.py:239"),
    "block_gate_signature_x": ("ruvector_tpu_torch/csrc/gated_block_attn.cu",
                               "ruvector_tpu/ops/pallas/gated_block_attn.py:423"),
    "block_gate_signature": ("ruvector_tpu_torch/csrc/gated_block_attn.cu",
                             "ruvector_tpu/ops/pallas/gated_block_attn.py:362"),
}
# kernels that no path of the JAX package reaches (shown, with launches 0)
OFF_PATH = {"block_gate_signature": "no caller in the JAX package (gated.py:291 is unused)"}
# config 5 (benchmarks/config5_r03.py, CONFIG5_BENCH_r05.json): clusters of
# 128 (benchmarks/scale_sweep_r02.py), 256-node partitions, k=16
C5_NODES, C5_CLUSTER, C5_BLOCK, C5_K = 999_936, 128, 256, 16
C5_KERNELS = ("gated_block_layer", "gated_block_layer_with_sig", "block_gate_signature_ln_x",
              "mincut_gate_block_from_x")
C5_STEPS = 5        # steady steps, then as many drift steps
C5_DRIFT = 0.1      # drift step: features += C5_DRIFT * N(0, 1)
# one layer of the kernel route (every product on bf16 operands, float32
# sums) against the plain sublayer composition under the same masks
# (float32 except bf16 Q/K/V and softmax weights): each bf16 operand is
# off by up to 2^-9 relative, and a layer chains about seven products
# into outputs of order 1-5, so a few 1e-2 at most and 1e-3 on average
C5_ROUTE_TOL = (5e-2, 5e-3)
# config 5's train step (benchmarks/config5_r03.py:204-226): timed steps,
# the SGD rate, and the partitions of the gradient check (the budget's
# count; the layout is halo-free, so a slice of partitions is its own graph)
C5_TRAIN_STEPS, C5_TRAIN_LR, C5_GRAD_PARTS = 4, 1e-3, 244
# config 5's layers on a layout with a halo: clusters of 120, two per
# 240-node partition (B % 32 = 16), k=16 of which 14 within the cluster
H_NODES, H_CLUSTER, H_BLOCK, H_K, H_K_IN = 120_000, 120, 240, 16, 14
H_STEPS = 2         # steady steps, then as many drift steps
CONTRASTIVE_STEPS = 3


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def agree(name: str, got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
          tol: tuple[float, float] | None = None) -> float:
    """Max abs error of got against want; raises beyond the tolerance
    (TOL[dtype] unless `tol` = (max, mean) is given)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             f"or non-finite output")
    err = (got - want).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    tol_max, tol_mean = tol or TOL[dtype]
    ok = max_err <= tol_max and mean_err <= tol_mean
    say("agree", name=name, dtype=str(dtype).replace("torch.", ""), max_abs_err=max_err,
        mean_abs_err=mean_err, tol_max=tol_max, tol_mean=tol_mean, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: disagrees with its reference")
    return max_err


def _agree_as(dtype: torch.dtype):
    """A report row's check: agree() with the tolerance of `dtype`."""
    return lambda name, got, want: agree(name, got, want, dtype)


def agree_scaled(name: str, got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
                 tol: tuple[float, float] | None = None) -> float:
    """agree() on errors relative to want's largest magnitude (for
    gradients, whose scale varies by tensor): max and mean of |got - want|
    / max|want| within TOL[dtype] (or `tol`). Returns the max abs error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             f"or non-finite output")
    scale = max(float(want.abs().max()), 1e-30)
    err = (got - want).abs()
    rel_max, rel_mean = float(err.max()) / scale, float(err.mean()) / scale
    tol_max, tol_mean = tol or TOL[dtype]
    ok = rel_max <= tol_max and rel_mean <= tol_mean
    say("agree", name=name, dtype=str(dtype).replace("torch.", ""), scale=scale,
        max_rel_err=rel_max, mean_rel_err=rel_mean, tol_max=tol_max, tol_mean=tol_mean, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: disagrees with its reference")
    return float(err.max())


def agree_grads(name: str, got, want, dtype: torch.dtype) -> float:
    """K5b's (dx, dA_cat, dWvo_cat) against its plain version, each
    relative to its own scale."""
    return max(agree_scaled(f"{name} {part}", g, w, dtype)
               for part, g, w in zip(("dx", "dA_cat", "dWvo_cat"), got, want))


def agree_rows(name: str, got, want) -> float:
    """Signature rows (rsum, rcnt) against the plain version's: the logits'
    products are summed in float64 on both sides (exact for bf16 products,
    within 2^-53 for f32 ones, rounded once), so the counts must be equal
    and the row sums (float64, rounded once) within 1e-6 relative. Returns
    the max abs error of rsum."""
    (rsum, rcnt), (wsum, wcnt) = got, want
    if rsum.shape != wsum.shape or not bool(torch.isfinite(rsum).all()):
        raise AssertionError(f"{name}: wrong shape or non-finite output")
    counts_equal = torch.equal(rcnt, wcnt)
    sums_close = bool(torch.allclose(rsum, wsum, rtol=1e-6, atol=0.0))
    say("agree", name=name, rows=rcnt.numel(), positive=int(wcnt.sum()),
        counts_equal=counts_equal, count_diffs=float((rcnt - wcnt).abs().sum()),
        sums_equal=torch.equal(rsum, wsum), sums_close=sums_close, sums_rtol=1e-6,
        ok=counts_equal and sums_close)
    if not (counts_equal and sums_close):
        raise AssertionError(f"{name}: disagrees with its reference")
    return float((rsum - wsum).abs().max())


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of one call on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: int, ops: dict) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate of their type, whichever is larger (ms)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[dt] for dt, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)


def phase_build() -> None:
    seconds = _lib.build()
    spills = []
    for name in _lib.SOURCES:
        log = _lib.log_path(name)
        text = log.read_text() if log.exists() else ""
        spills += [line.strip() for line in text.splitlines()
                   if re.search(r"\b[1-9]\d* bytes spill", line)]
        _lib.load(name)
    say("build", seconds=round(seconds, 3), sources=",".join(_lib.SOURCES),
        ptxas_lines_with_spills=len(spills))
    for line in spills[:8]:
        print("  ptxas:", line, flush=True)


def _sparse_wd(nb, b, t, per_row, gen):
    """Normalized weights of ~per_row edges per row, a degree-0 row and a
    real zero-weight edge (1e-7)."""
    cols = torch.randint(0, t, (nb, b, per_row), generator=gen)
    w = torch.zeros(nb, b, t)
    w.scatter_(2, cols, torch.rand(nb, b, per_row, generator=gen) + 0.05)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-10)
    w[0, 3] = 0.0
    w[0, 5, cols[0, 5, 0]] = 1e-7
    return w


def phase_parity(params, cfg) -> None:
    """Each kernel against its plain version at the main path's widths
    (D=128, H=4), with a ragged B, a local table T > 512 (a real halo),
    with and without log_mult, in f32 and bf16."""
    gen = torch.Generator().manual_seed(0)
    nb, b, t, d, h = 6, 504, 1024, cfg.hidden_dim, cfg.heads
    wd = _sparse_wd(nb, b, t, 16, gen).to(DEV)
    lm = torch.log(torch.randint(1, 3, (nb, b, t), generator=gen).float()).to(DEV)
    folded = fold_layer_params(params, cfg)
    for cdt in (torch.float32, torch.bfloat16):
        L = torch.randn(nb, t, d, generator=gen).to(DEV, cdt)
        u = (0.3 * torch.randn(h, nb, b, d, generator=gen)).to(DEV, cdt)
        sb = torch.randn(h, nb, b, generator=gen).to(DEV)
        msg = torch.randn(nb, b, d, generator=gen).to(DEV)
        for lm_case in (None, lm):
            tag = "" if lm_case is None else "+lm"
            agree(f"K2 block_dense_attention T={t}{tag}",
                  block_dense_attention(L, u, sb, wd, lm_case, scale=0.25),
                  block_dense_attention_reference(L, u, sb, wd, lm_case, scale=0.25), cdt)
            agree(f"K1 block_dense_layer_fused T={t}{tag}",
                  block_dense_layer_fused(L, msg, wd, folded, lm_case, dropout=0.0,
                                          eps=cfg.eps),
                  block_dense_layer_fused_reference(L, msg, wd, folded, lm_case,
                                                    dropout=0.0, eps=cfg.eps), cdt)
    n, m = 4099, 16
    k3 = [torch.randn(s, generator=gen).to(DEV) for s in ((n, h, d), (n, h), (n, m, d))]
    mask = (torch.rand(n, m, generator=gen) > 0.2).float().to(DEV)
    mask[7] = 0.0
    wnorm = normalized_weights(torch.rand(n, m, generator=gen).to(DEV), mask)
    agree(f"K3 fused_neighbor_mix N={n}",
          fused_neighbor_mix(*k3, mask, wnorm, heads=h, scale=0.25),
          fused_neighbor_mix_reference(*k3, mask, wnorm, heads=h, scale=0.25),
          torch.float32)
    torch.cuda.synchronize()


def bench_features(n: int, d: int) -> np.ndarray:
    """bench.py's clustered data: 1000 centers x (n/1000) points, std 0.25."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(1000, d)).astype(np.float32)
    return (centers[rng.integers(0, 1000, size=n)]
            + 0.25 * rng.normal(size=(n, d))).astype(np.float32)


def counted(kernel_names, fn):
    """Run fn with every launch count at 0 before and read just after;
    fail if a kernel of this path was never launched."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in kernel_names:
        if counts[name] < 1:
            raise AssertionError(f"{name} was not launched on its path: {counts}")
    return out, counts


# ---------------------------------------------------------------------------
# config 5: the min-cut-gated graph transformer
# ---------------------------------------------------------------------------

def agree_signature(name: str, got, x, pad, sig, compute_bf16: bool, eps: float) -> float:
    """K6c's rows (rsum, rcnt) of x against the plain version on x (the
    kernel's LayerNorm is the plain one step for step): agree_rows."""
    return agree_rows(name, got, block_gate_signature_ln_x_reference(
        x, pad, *sig, eps=eps, compute_bf16=compute_bf16))


def agree_layer_with_sig(name: str, got, want, pad, sig, dtype: torch.dtype,
                         eps: float) -> float:
    """K4b (out, rsum, rcnt) against its plain version (want = the plain
    layer's output and signature): the output to the layer tolerance of
    `dtype`, the signature to the plain signature of the kernel's own
    output (in bf16 the plain layer's output differs from the kernel's
    within the layer tolerance, and the signature is discontinuous at
    eps). Returns the larger max abs error of out and rsum."""
    out, rsum, rcnt = got
    out_err = agree(f"{name} out", out, want[0], dtype)
    return max(out_err, agree_signature(f"{name} signature", (rsum, rcnt), out, pad, sig,
                                        dtype == torch.bfloat16, eps))


def agree_gate(name: str, got, want) -> float:
    """K7 (keep words, stats) against its plain version: the logits are the
    same bits in both (the plain LayerNorm step for step, float64 sums),
    so the masks and the applied flags must be equal; the cut cost within
    1e-4, or 2e-3 relative where a cut applies (push amounts may differ in
    ulps; the cut does not). Returns the max abs error of the cut cost."""
    (kp, st), (wkp, wst) = got, want
    masks_equal = torch.equal(kp, wkp)
    applied_equal = torch.equal(st[:, 2], wst[:, 2])
    err = (st[:, 0, 0] - wst[:, 0, 0]).abs()
    cost_ok = bool((err <= torch.clamp(2e-3 * wst[:, 0, 0].abs(), min=1e-4)).all())
    b = kp.shape[-1]
    ok = masks_equal and applied_equal and cost_ok
    say("agree", name=name, partitions=kp.shape[0], masks_equal=masks_equal,
        bits_differ=int((unpack_keep(kp, b) != unpack_keep(wkp, b)).sum()),
        applied_equal=applied_equal, cuts_applied=int(st[:, 2, 0].sum()),
        cost_max_abs_err=float(err.max()), ok=ok)
    if not ok:
        raise AssertionError(f"{name}: disagrees with its reference")
    return float(err.max())


def gate_qs_bf16(x, pad, A_sig, *, lam, eps, ln, compute_bf16):
    """A faulty plain K7 for the controls: qs = X A_sig rounded to bf16
    before the logits (K6c's rounding in K7's place)."""
    X = layer_norm_rows(x.float(), *ln)
    if compute_bf16:
        X = X.to(torch.bfloat16).float()
    lg = matmul_f64(as_cdt(matmul_f64(X, A_sig), torch.bfloat16), X.transpose(1, 2))
    valid = (pad[:, :, None] * pad[:, None, :]) > 0
    return gate_from_logits(torch.where(valid, lg, torch.full_like(lg, -1.0)), lam=lam, eps=eps)


def expect_rejected(name: str, check) -> None:
    """A control: `check` holds a deliberately wrong result against the
    plain version and must raise."""
    try:
        check()
    except AssertionError:
        say("control", name=name, rejected=True)
        return
    raise AssertionError(f"control {name}: a wrong result passed the check")


def phase_gated_parity(gparams, gcfg) -> None:
    """K4a/K4b/K6c/K7 against their plain versions at config 5's widths
    (D=128, 4 heads, FFN x4, B=256), with a short tail block (pad rows),
    a sparse keep mask with a row that keeps nothing, a degree-0 row, in
    f32 and bf16 compute; K7 on random partitions and on partitions built
    so that the cut applies."""
    gen = torch.Generator().manual_seed(1)
    nb, b, d = 3, C5_BLOCK, gcfg.dim
    x = torch.randn(nb, b, d, generator=gen).to(DEV)
    pad = torch.ones(nb, b)
    pad[-1, 200:] = 0.0
    pad = pad.to(DEV)
    keep = torch.rand(nb, b, b, generator=gen) < 0.3
    keep[0, 5] = False
    keep = pack_keep(keep).to(DEV)
    wd = _sparse_wd(nb, b, b, C5_K, gen).to(DEV)
    p, p_next = gparams
    folded = fold_gated_layer_params(p, gcfg)
    sig = (gated._fold_sig_params(p_next, gcfg), *gated._ln_vectors(p_next["ln1"]))
    for cbf in (False, True):
        cdt, tag = (torch.bfloat16, "bf16") if cbf else (torch.float32, "f32")
        wdc = wd.to(cdt)
        out = gated_block_layer(x, keep, pad, wdc, folded, compute_bf16=cbf)
        agree(f"K4a gated_block_layer B={b} {tag}", out,
              gated_block_layer_reference(x, keep, pad, wdc, folded, compute_bf16=cbf), cdt)
        out_b, rsum, rcnt = gated_block_layer_with_sig(x, keep, pad, wdc, folded, *sig,
                                                       compute_bf16=cbf, sig_eps=gcfg.eps)
        agree_layer_with_sig(
            f"K4b gated_block_layer_with_sig {tag}", (out_b, rsum, rcnt),
            gated_block_layer_with_sig_reference(x, keep, pad, wdc, folded, *sig,
                                                 compute_bf16=cbf, sig_eps=gcfg.eps),
            pad, sig, cdt, gcfg.eps)
        # one code path: K4b's output is K4a's, and its signature is K6c's
        # on the written output, bit for bit
        rs6, rc6 = block_gate_signature_ln_x(out, pad, *sig, eps=gcfg.eps, compute_bf16=cbf)
        same = torch.equal(out_b, out) and torch.equal(rsum, rs6) and torch.equal(rcnt, rc6)
        say("agree", name=f"K4b = K4a then K6c, bitwise {tag}", ok=same)
        if not same:
            raise AssertionError("K4b disagrees bitwise with K4a followed by K6c")
        agree_signature(f"K6c block_gate_signature_ln_x {tag}",
                        block_gate_signature_ln_x(x, pad, *sig, eps=gcfg.eps, compute_bf16=cbf),
                        x, pad, sig, cbf, gcfg.eps)
    # control: f32 products where the signature takes bf16 ones
    expect_rejected("K6c with float32 instead of bf16 products", lambda: agree_signature(
        "control: signature with float32 products",
        block_gate_signature_ln_x_reference(x, pad, *sig, eps=gcfg.eps, compute_bf16=False),
        x, pad, sig, True, gcfg.eps))
    A0, ln0 = gated._fold_sig_params(p, gcfg), gated._ln_vectors(p["ln1"])
    xr = torch.randn(6, b, d, generator=gen).to(DEV)
    pad_r = torch.ones(6, b)
    pad_r[-1, 230:] = 0.0
    pad_r = pad_r.to(DEV)
    gate = dict(lam=gcfg.lam, eps=gcfg.eps)
    for cbf in (False, True):
        want = mincut_gate_block_from_x_reference(xr, pad_r, A0, ln=ln0, compute_bf16=cbf,
                                                  **gate)
        agree_gate(f"K7 mincut_gate_block_from_x random B={b} bf16={cbf}",
                   mincut_gate_block_from_x(xr, pad_r, A0, ln=ln0, compute_bf16=cbf, **gate),
                   want)
    # control: qs rounded to bf16 where the gate keeps it float32
    expect_rejected("K7 with qs rounded to bf16", lambda: agree_gate(
        "control: gate with qs rounded to bf16",
        gate_qs_bf16(xr, pad_r, A0, ln=ln0, compute_bf16=True, **gate), want))
    xs = isolated_sink(torch.randn(4, b, d, generator=gen), 0.1, gcfg.eps).to(DEV)
    ps, eye = torch.ones(4, b, device=DEV), 0.1 * torch.eye(d, device=DEV)
    got = mincut_gate_block_from_x(xs, ps, eye, **gate)
    agree_gate(f"K7 mincut_gate_block_from_x isolated sink B={b}", got,
               mincut_gate_block_from_x_reference(xs, ps, eye, **gate))
    applied = int(got[1][:, 2, 0].sum())
    say("gate_cuts", partitions=4, applied=applied)
    if applied != 4:
        raise AssertionError("the isolated-sink partitions must all apply their cut")
    torch.cuda.synchronize()


def phase_train_parity(gparams, gcfg) -> None:
    """K5a, K5b, K6a and K6b against their plain versions at config 5's
    widths (D=128, 4 heads, B=256), with a short tail block (pad rows), a
    sparse keep mask with a row that keeps nothing, in f32 and bf16
    compute; and the control: K5b's dA reduced without partition 0's
    partial must fail the dA check."""
    gen = torch.Generator().manual_seed(2)
    nb, b, d = 3, C5_BLOCK, gcfg.dim
    h = torch.randn(nb, b, d, generator=gen).to(DEV)
    g = torch.randn(nb, b, d, generator=gen).to(DEV)
    pad = torch.ones(nb, b)
    pad[-1, 200:] = 0.0
    pad = pad.to(DEV)
    keep = torch.rand(nb, b, b, generator=gen) < 0.3
    keep[0, 5] = False
    keep = pack_keep(keep).to(DEV)
    p = gparams[0]
    A, Wvo = fold_gated_attention_params(p, gcfg)
    A_cat, Wvo_cat = head_concat(A), head_concat(Wvo)
    A_sig = gated._fold_sig_params(p, gcfg)
    scale = 1.0 / (gcfg.head_dim ** 0.5) / gcfg.num_heads
    for cbf in (False, True):
        cdt, tag = (torch.bfloat16, "bf16") if cbf else (torch.float32, "f32")
        args = (h, keep, pad, A_cat, Wvo_cat)
        agree(f"K5a gated_block_attention_fwd B={b} {tag}",
              gated_block_attention_fwd(*args, compute_bf16=cbf),
              gated_block_attention_fwd_reference(*args, compute_bf16=cbf), cdt)
        agree_grads(f"K5b gated_block_attention_bwd B={b} {tag}",
                    gated_block_attention_bwd(*args, g, compute_bf16=cbf),
                    gated_block_attention_bwd_reference(*args, g, compute_bf16=cbf), cdt)
        agree_rows(f"K6b block_gate_signature_x {tag}",
                   block_gate_signature_x(h, pad, A_sig, eps=gcfg.eps, compute_bf16=cbf),
                   block_gate_signature_x_reference(h, pad, A_sig, eps=gcfg.eps,
                                                    compute_bf16=cbf))
        q, k = gated._qk_proj(h, p["wq"], p["wk"], dataclasses.replace(
            gcfg, compute_dtype="bfloat16" if cbf else "float32"))
        agree_rows(f"K6a block_gate_signature q/k {tag}",
                   block_gate_signature(q, k, pad, eps=gcfg.eps, scale=scale),
                   block_gate_signature_reference(q, k, pad, eps=gcfg.eps, scale=scale))
    # control: one partition's dA partial left out of the reduction (with
    # nB = 3 partitions each block of the grid holds exactly one)
    dx, dA_parts, _ = gated_block_attention_bwd_partials(h, keep, pad, A_cat, Wvo_cat, g,
                                                         compute_bf16=False)
    if dA_parts.shape[0] != nb:
        raise AssertionError(f"K5b's grid holds {dA_parts.shape[0]} partials, not one per "
                             f"partition ({nb})")
    want_dA = gated_block_attention_bwd_reference(h, keep, pad, A_cat, Wvo_cat, g,
                                                  compute_bf16=False)[1]
    agree_scaled("K5b dA from its partials, all partitions", reduce_partials(dA_parts), want_dA,
                 torch.float32)
    expect_rejected("K5b dA without partition 0's partial", lambda: agree_scaled(
        "control: K5b dA without partition 0's partial",
        reduce_partials(dA_parts[1:].contiguous()), want_dA, torch.float32))
    torch.cuda.synchronize()


def cluster_graph(n: int, d: int, k: int, seed: int = 0, chunk: int = 512):
    """Config 5's data (benchmarks/scale_sweep_r02.py:82-94), made on the
    card: clusters of C5_CLUSTER points around N(0, 1) centres with std
    0.25, contiguous, and the exact within-cluster kNN (self excluded)
    with weights 1/(1 + dist). Returns (feats [n, d] f32, idx [n, k]
    int32, ew [n, k] f32), on the card."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    nc, c_sz = n // C5_CLUSTER, C5_CLUSTER
    feats = torch.empty(n, d, device=DEV)
    idx = torch.empty(n, k, dtype=torch.int32, device=DEV)
    ew = torch.empty(n, k, device=DEV)
    self_pair = 1e30 * torch.eye(c_sz, device=DEV)
    for s in range(0, nc, chunk):
        c = min(chunk, nc - s)
        pts = (torch.randn(c, 1, d, generator=gen, device=DEV)
               + 0.25 * torch.randn(c, c_sz, d, generator=gen, device=DEV))
        sq = (pts * pts).sum(-1)
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(pts, pts.transpose(1, 2))
        neg, nn_idx = torch.topk(-(d2 + self_pair), k, dim=-1)
        rows = slice(s * c_sz, (s + c) * c_sz)
        feats[rows] = pts.reshape(-1, d)
        base = torch.arange(s, s + c, device=DEV, dtype=torch.int32)[:, None, None] * c_sz
        idx[rows] = (nn_idx.int() + base).reshape(-1, k)
        ew[rows] = (1.0 / (1.0 + torch.sqrt(torch.clamp(-neg, min=0.0)))).reshape(-1, k)
    return feats, idx, ew


def _synced_ms(fn):
    """(result, host milliseconds) of fn, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_config5(gparams, gcfg, d: int) -> dict:
    """The serving path of config 5 at full width: gate_state_init, steady
    steps (each must re-solve 0 partitions: K4b's emitted signature
    equals K6c's), drift steps (each must re-solve between 1 and twice
    the budget), one layer of the kernel route against the plain
    composition under the same masks, and K7 re-solving layer 0's gates
    over every partition (the init masks, reproduced)."""
    t0 = time.perf_counter()
    feats, idx, ew = cluster_graph(C5_NODES, d, C5_K)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bdg = build_block_dense(idx.cpu().numpy(), np.ones((C5_NODES, C5_K), np.float32),
                            ew.cpu().numpy(), block=C5_BLOCK, device=DEV)
    layout_s = time.perf_counter() - t0
    del idx, ew
    nb, b = bdg.n_blocks, bdg.block
    if bdg.table != b or nb * b != C5_NODES:
        raise AssertionError(f"config 5 layout is not halo-free: nB={nb} B={b} T={bdg.table}")
    budget = max(1, int(nb * gcfg.max_resolve_frac))
    fpad = bdg.pad_features(feats)
    del feats
    step = gated.gated_graph_transformer_step

    # --- init: every gate solved once -------------------------------------
    (state, init_ms), init_counts = counted(
        ["mincut_gate_block_from_x", "block_gate_signature_ln_x", "gated_block_layer"],
        lambda: _synced_ms(lambda: gated.gate_state_init(gparams, gcfg, fpad, bdg)))

    # --- steady steps: the same input reuses every gate ---------------------
    def steady():
        st, times, res = state, [], []
        for _ in range(C5_STEPS):
            (out, st, nres), ms = _synced_ms(lambda: step(gparams, gcfg, fpad, bdg, st))
            times.append(ms)
            res.append(nres)
        return out, st, times, res

    (out, st_steady, steady_ms, steady_res), steady_counts = counted(
        ["block_gate_signature_ln_x", "gated_block_layer_with_sig", "gated_block_layer"],
        steady)
    if any(steady_res) or out.shape != fpad.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"steady steps re-solved {steady_res} partitions (must be 0) "
                             "or gave a non-finite output")

    # --- drift steps: features move each step; the perturbation is outside
    # the timed window ---------------------------------------------------
    noise = torch.Generator(device=DEV).manual_seed(7)
    padcol = bdg.node_pad.reshape(-1, 1)

    def drift():
        f, st, times, res = fpad, st_steady, [], []
        for _ in range(C5_STEPS):
            f = f + C5_DRIFT * torch.randn(f.shape, generator=noise, device=DEV) * padcol
            (out, st, nres), ms = _synced_ms(lambda: step(gparams, gcfg, f, bdg, st))
            times.append(ms)
            res.append(nres)
        return out, f, times, res

    (out, f_drift, drift_ms, drift_res), drift_counts = counted(
        ["mincut_gate_block_from_x", "block_gate_signature_ln_x",
         "gated_block_layer_with_sig", "gated_block_layer"], drift)
    if (not all(0 < r <= 2 * budget for r in drift_res) or out.shape != fpad.shape
            or not bool(torch.isfinite(out).all())):
        raise AssertionError(f"drift steps re-solved {drift_res} partitions (must be in "
                             f"1..{2 * budget}) or gave a non-finite output")

    # --- one layer: kernel route (K4a) vs the plain composition -----------
    x0, keep0 = fpad.reshape(nb, b, d), state["keep"][0]
    k_out = gated._layer_with_keep(gparams[0], gcfg, x0, bdg, keep0, fused=True)
    p_out = gated._layer_with_keep(gparams[0], dataclasses.replace(gcfg, fused_gate_attn="never"),
                                   x0, bdg, keep0, fused=True)
    agree("config5 layer 0: kernel route (K4a) vs plain composition", k_out, p_out,
          torch.bfloat16, tol=C5_ROUTE_TOL)
    del k_out, p_out

    # --- K7 over every partition: its plain version's masks, and the init
    # masks again ----------------------------------------------------------
    A0, ln0 = gated._fold_sig_params(gparams[0], gcfg), gated._ln_vectors(gparams[0]["ln1"])
    gate = dict(lam=gcfg.lam, eps=gcfg.eps, ln=ln0, compute_bf16=True)
    kp, stats = mincut_gate_block_from_x(x0, bdg.node_pad, A0, **gate)
    agree_gate(f"K7 at the init shape (K={nb})", (kp, stats),
               mincut_gate_block_from_x_reference(x0, bdg.node_pad, A0, **gate))
    if not torch.equal(kp, keep0):
        raise AssertionError("K7 over every partition does not reproduce the init masks")
    edges = C5_NODES * C5_K * gcfg.num_layers
    steady_med, drift_med = statistics.median(steady_ms), statistics.median(drift_ms)
    say("config5", nodes=C5_NODES, nB=nb, B=b, d=d, heads=gcfg.num_heads,
        layers=gcfg.num_layers, budget=budget, edges_per_step=edges, gen_s=round(gen_s, 3),
        layout_s=round(layout_s, 3), gate_init_ms=init_ms, forward_steady_ms=steady_med,
        forward_drift_ms=drift_med, resolved_per_drift_step=drift_res,
        cuts_applied=int(stats[:, 2, 0].sum()), edges_per_s_steady=edges / (steady_med * 1e-3),
        edges_per_s_drift=edges / (drift_med * 1e-3))
    say("config5_steps", steady_ms=[round(t, 3) for t in steady_ms],
        drift_ms=[round(t, 3) for t in drift_ms],
        mean_push_relabel_rounds=float(stats[:, 3, 0].mean()))
    say("config5_launches", init=_nonzero(init_counts), steady=_nonzero(steady_counts),
        drift=_nonzero(drift_counts))
    launches = {name: steady_counts[name] + drift_counts[name] for name in C5_KERNELS}
    sel = torch.randperm(nb, generator=noise, device=DEV)[:budget]
    return dict(bdg=bdg, x0=x0, keep0=keep0, keep=state["keep"],
                x_sel=f_drift.reshape(nb, b, d)[sel].contiguous(),
                pad_sel=bdg.node_pad[sel].contiguous(), launches=launches)


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def config5_report(c5: dict, gparams, gcfg) -> list:
    """Report rows of the config-5 kernels at the step path's shapes:
    K4a/K4b/K6c on every partition (layer 0's input and init masks), K7
    at the step shape (budget partitions of drifted features) and, for
    its time only, at the init shape (every partition)."""
    bdg, x0, keep0 = c5["bdg"], c5["x0"], c5["keep0"]
    pad = bdg.node_pad
    nb, b, d = x0.shape
    hh, fm = gcfg.num_heads, gcfg.ffn_mult
    wd = gated._kernel_wdense(gcfg, bdg)
    folded = fold_gated_layer_params(gparams[0], gcfg)
    A0, ln0 = gated._fold_sig_params(gparams[0], gcfg), gated._ln_vectors(gparams[0]["ln1"])
    sig = (gated._fold_sig_params(gparams[1], gcfg), *gated._ln_vectors(gparams[1]["ln1"]))
    n = nb * b
    bf16 = torch.bfloat16
    layer_ops = 2 * n * (hh * (2 * d + 2 * b) * d + (b + d) * d + 2 * fm * d * d)
    sig_ops = 2 * n * (b + d) * d
    layer_bytes = nbytes(x0, keep0, pad, wd, *folded.values()) + nbytes(x0)
    sig_out = 2 * n * 4
    rows = []
    k4a = lambda: gated_block_layer(x0, keep0, pad, wd, folded, compute_bf16=True)  # noqa: E731
    k4a_ref = lambda: gated_block_layer_reference(  # noqa: E731
        x0, keep0, pad, wd, folded, compute_bf16=True)
    rows.append(("gated_block_layer", k4a, k4a_ref,
                 _agree_as(bf16),
                 bound(layer_bytes, {bf16: layer_ops}), {}))
    k4b = lambda: gated_block_layer_with_sig(  # noqa: E731
        x0, keep0, pad, wd, folded, *sig, compute_bf16=True, sig_eps=gcfg.eps)
    k4b_ref = lambda: gated_block_layer_with_sig_reference(  # noqa: E731
        x0, keep0, pad, wd, folded, *sig, compute_bf16=True, sig_eps=gcfg.eps)
    rows.append(("gated_block_layer_with_sig", k4b, k4b_ref,
                 lambda name, got, want: agree_layer_with_sig(name, got, want, pad, sig, bf16,
                                                              gcfg.eps),
                 bound(layer_bytes + nbytes(*sig) + sig_out, {bf16: layer_ops + sig_ops}), {}))
    k6c = lambda: block_gate_signature_ln_x(x0, pad, A0, *ln0, eps=gcfg.eps,  # noqa: E731
                                            compute_bf16=True)
    k6c_ref = lambda: block_gate_signature_ln_x_reference(  # noqa: E731
        x0, pad, A0, *ln0, eps=gcfg.eps, compute_bf16=True)
    rows.append(("block_gate_signature_ln_x", k6c, k6c_ref,
                 lambda name, got, want: agree_signature(name, got, x0, pad, (A0, *ln0), True,
                                                         gcfg.eps),
                 bound(nbytes(x0, pad, A0, *ln0) + sig_out, {bf16: sig_ops}), {}))

    gate = dict(lam=gcfg.lam, eps=gcfg.eps, ln=ln0, compute_bf16=True)
    x_sel, pad_sel = c5["x_sel"], c5["pad_sel"]

    def gate_bound(x, pad_k, kp, stats):
        """Logits (float32) plus ~10 B^2 operations per push-relabel round,
        with this run's rounds (stats row 3)."""
        ops = 2 * x.shape[0] * b * d * (b + d) + 10 * b * b * int(stats[:, 3, 0].sum())
        return bound(nbytes(x, pad_k, A0, *ln0, kp, stats), {torch.float32: ops})

    k7 = lambda: mincut_gate_block_from_x(x_sel, pad_sel, A0, **gate)  # noqa: E731
    k7_ref = lambda: mincut_gate_block_from_x_reference(x_sel, pad_sel, A0, **gate)  # noqa: E731
    k7_init = lambda: mincut_gate_block_from_x(x0, pad, A0, **gate)  # noqa: E731
    init_out = k7_init()
    init_bound_ms, _ = gate_bound(x0, pad, *init_out)
    step_out = k7()
    rows.append(("mincut_gate_block_from_x", k7, k7_ref, agree_gate,
                 gate_bound(x_sel, pad_sel, *step_out),
                 {"shape": f"step: K={x_sel.shape[0]} partitions (plain_ms at this shape "
                           f"only)",
                  "ms_init_shape": time_ms(k7_init, iters=2, warmup=0),
                  "bound_ms_init_shape": init_bound_ms,
                  "init_shape": f"K={nb} partitions",
                  "rounds_step": int(step_out[1][:, 3, 0].sum()),
                  "rounds_init": int(init_out[1][:, 3, 0].sum())}))
    return rows


# ---------------------------------------------------------------------------
# training: config 5's train step, the halo layout, the contrastive step
# ---------------------------------------------------------------------------

def _leaves(params):
    """The trainable tensors of the gated model, in a fixed order."""
    return [t for layer in params for t in gated._flatten(layer)[1]]


def _rebuild(params, leaves):
    it = iter(leaves)
    out = []
    for layer in params:
        keys, vals = gated._flatten(layer)
        out.append(gated._unflatten(keys, [next(it) for _ in vals]))
    return out


def _loss_and_grads(params, cfg, fpad, bdg, keep):
    """config5_r03's loss (zero targets, the state's masks) and its
    gradient, for every leaf of params."""
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    loss = gated.gated_graph_transformer_loss_with_masks(
        _rebuild(params, leaves), cfg, fpad, bdg, keep, torch.zeros_like(fpad))
    return loss.detach(), leaves, torch.autograd.grad(loss, leaves)


def _grads_agree(name, params, cfg, fpad, bdg, keep) -> None:
    """The kernel route's parameter gradients against the plain route's,
    each leaf relative to its own scale, at C5_ROUTE_TOL."""
    _, _, kernel = _loss_and_grads(params, cfg, fpad, bdg, keep)
    _, _, plain = _loss_and_grads(params, dataclasses.replace(cfg, fused_gate_attn="never"),
                                  fpad, bdg, keep)
    names = [f"{li}/{'/'.join(k)}" for li, layer in enumerate(params)
             for k in gated._flatten(layer)[0]]
    for leaf, kg, pg in zip(names, kernel, plain):
        agree_scaled(f"{name} grad {leaf}", kg, pg, torch.bfloat16, tol=C5_ROUTE_TOL)


def first_partitions(bdg, k: int):
    """The first k partitions of a halo-free layout as their own graph."""
    if bdg.table != bdg.block:
        raise AssertionError("a slice of partitions is its own graph only without a halo")
    b = bdg.block
    return dataclasses.replace(bdg, local_ids=bdg.local_ids[:k], wdense=bdg.wdense[:k],
                               degrees=bdg.degrees[:k], node_pad=bdg.node_pad[:k],
                               node_pos=bdg.node_pos[bdg.node_pos < k * b],
                               n=int(bdg.node_pad[:k].sum()), log_mult=None)


def phase_config5_train(gparams, gcfg, c5: dict) -> dict:
    """Config 5's train step at full width on the serving phase's graph,
    weights and init masks: C5_TRAIN_STEPS steps of loss, gradient and
    w - lr g (remat on, bf16 compute on f32 features). Each step must
    launch K4a once per layer (forward) and K5a and K5b once per layer
    (the fused layer's backward recompute), and no other kernel. Then the
    kernel route's gradients against the plain route's on the first
    C5_GRAD_PARTS partitions."""
    bdg, keep = c5["bdg"], c5["keep"]
    nb, b, d = c5["x0"].shape
    fpad = c5["x0"].reshape(nb * b, d)
    cfg = dataclasses.replace(gcfg, remat=True)
    layers = len(gparams)

    def train_step(params):
        loss, leaves, grads = _loss_and_grads(params, cfg, fpad, bdg, keep)
        with torch.no_grad():
            return _rebuild(params, [w - C5_TRAIN_LR * g for w, g in zip(leaves, grads)]), loss

    def run():
        params, times, losses = gparams, [], []
        for _ in range(C5_TRAIN_STEPS):
            (params, loss), ms = _synced_ms(lambda: train_step(params))
            times.append(ms)
            losses.append(float(loss))
        return params, times, losses

    torch.cuda.reset_peak_memory_stats()
    (params, times, losses), counts = counted(
        ["gated_block_layer", "gated_block_attention_fwd", "gated_block_attention_bwd"], run)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: v / C5_TRAIN_STEPS for k, v in counts.items() if v}
    want = {k: layers for k in ("gated_block_layer", "gated_block_attention_fwd",
                                "gated_block_attention_bwd")}
    if per_step != want or not all(np.isfinite(losses)):
        raise AssertionError(f"train step launches {per_step} (must be {want}) or a "
                             f"non-finite loss {losses}")
    moved = max(float((a - w).abs().max()) for a, w in zip(_leaves(params), _leaves(gparams)))
    if not moved > 0:
        raise AssertionError("the train steps did not move the parameters")
    sub = first_partitions(bdg, C5_GRAD_PARTS)
    _grads_agree(f"config5 train, first {C5_GRAD_PARTS} partitions: kernel vs plain route",
                 gparams, cfg, c5["x0"][:C5_GRAD_PARTS].reshape(-1, d), sub,
                 keep[:, :C5_GRAD_PARTS].contiguous())
    step_ms = statistics.median(times)
    edges = C5_NODES * C5_K * layers
    say("config5_train", nodes=nb * b, nB=nb, B=b, d=d, layers=layers, remat=True, lr=C5_TRAIN_LR,
        train_step_ms=step_ms, steps_ms=[round(t, 3) for t in times], losses=losses,
        edges_per_s=edges / (step_ms * 1e-3), peak_mem_gb=round(peak_gb, 2),
        launches_per_step=per_step, grad_check_partitions=C5_GRAD_PARTS)
    return {k: counts[k] for k in want}


def halo_graph(n: int, d: int, seed: int = 1):
    """Clusters of H_CLUSTER points (centres N(0, 1), std 0.25, contiguous,
    made on the card); each node's H_K_IN nearest within its cluster (self
    excluded) and H_K - H_K_IN random nodes of other clusters, weights
    1/(1 + dist). Returns (feats, idx int32, ew) on the card."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    nc, c = n // H_CLUSTER, H_CLUSTER
    pts = (torch.randn(nc, 1, d, generator=gen, device=DEV)
           + 0.25 * torch.randn(nc, c, d, generator=gen, device=DEV))
    sq = (pts * pts).sum(-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(pts, pts.transpose(1, 2))
    neg, nn_idx = torch.topk(-(d2 + 1e30 * torch.eye(c, device=DEV)), H_K_IN, dim=-1)
    base = torch.arange(nc, device=DEV)[:, None, None] * c
    inner = (nn_idx + base).reshape(n, H_K_IN)
    dist_in = torch.sqrt(torch.clamp(-neg, min=0.0)).reshape(n, H_K_IN)
    own = torch.arange(n, device=DEV)[:, None] // c
    other = (own + torch.randint(1, nc, (n, H_K - H_K_IN), generator=gen, device=DEV)) % nc
    outer = other * c + torch.randint(0, c, (n, H_K - H_K_IN), generator=gen, device=DEV)
    feats = pts.reshape(n, d)
    dist_out = torch.linalg.vector_norm(feats[outer] - feats[:, None, :], dim=-1)
    idx = torch.cat([inner, outer], dim=1).int()
    ew = 1.0 / (1.0 + torch.cat([dist_in, dist_out], dim=1))
    return feats, idx, ew


def phase_config5_halo(gparams, gcfg) -> dict:
    """Config 5's layers on a layout with a halo and B % 32 != 0: the
    signature is K6b and the gate the plain batched one (the JAX
    package's choice at B % 32 != 0), each layer LN1, K5a and the plain
    mix and FFN. gate_state_init, H_STEPS steady and H_STEPS drift steps,
    one train step; the steady step's output and the train step's
    gradients against the plain route."""
    d = gcfg.dim
    t0 = time.perf_counter()
    feats, idx, ew = halo_graph(H_NODES, d)
    bdg = build_block_dense(idx.cpu().numpy(), np.ones((H_NODES, H_K), np.float32),
                            ew.cpu().numpy(), block=H_BLOCK, device=DEV)
    layout_s = time.perf_counter() - t0
    nb, b = bdg.n_blocks, bdg.block
    if bdg.table <= b or b % 32 == 0:
        raise AssertionError(f"the halo layout has no halo or B % 32 == 0: B={b} T={bdg.table}")
    budget = max(1, int(nb * gcfg.max_resolve_frac))
    fpad = bdg.pad_features(feats)
    step = gated.gated_graph_transformer_step
    step_kernels = ["block_gate_signature_x", "gated_block_attention_fwd"]
    off_route = ("gated_block_layer", "gated_block_layer_with_sig", "block_gate_signature_ln_x",
                 "mincut_gate_block_from_x")
    with torch.no_grad():
        (state, init_ms), init_counts = counted(
            step_kernels, lambda: _synced_ms(lambda: gated.gate_state_init(gparams, gcfg, fpad,
                                                                           bdg)))

        def steps(inputs):
            st, out, times, res = state, None, [], []
            for f in inputs:
                (out, st, nres), ms = _synced_ms(lambda: step(gparams, gcfg, f, bdg, st))
                times.append(ms)
                res.append(nres)
            return out, times, res

        noise = torch.Generator(device=DEV).manual_seed(8)
        padcol = bdg.node_pad.reshape(-1, 1)
        drifted = [fpad + C5_DRIFT * (i + 1) * torch.randn(fpad.shape, generator=noise,
                                                           device=DEV) * padcol
                   for i in range(H_STEPS)]
        (out, steady_ms, steady_res), steady_counts = counted(
            step_kernels, lambda: steps([fpad] * H_STEPS))
        (out_d, drift_ms, drift_res), drift_counts = counted(step_kernels,
                                                             lambda: steps(drifted))
        if (any(steady_res) or not all(0 <= r <= 2 * budget for r in drift_res)
                or sum(drift_res) < 1 or not bool(torch.isfinite(out_d).all())):
            raise AssertionError(f"halo steps re-solved {steady_res} / {drift_res} partitions "
                                 f"(must be 0 / at most {2 * budget}, some) or gave a "
                                 "non-finite output")
        out_plain, _, _ = step(gparams, dataclasses.replace(gcfg, fused_gate_attn="never"), fpad,
                               bdg, state)
        agree("config5 halo steady step: kernel route vs plain route", out, out_plain,
              torch.bfloat16, tol=C5_ROUTE_TOL)
    (loss, _, _), train_counts = counted(
        ["gated_block_attention_fwd", "gated_block_attention_bwd"],
        lambda: _loss_and_grads(gparams, gcfg, fpad, bdg, state["keep"]))
    _, train_ms = _synced_ms(lambda: _loss_and_grads(gparams, gcfg, fpad, bdg, state["keep"]))
    layers = len(gparams)
    for what, counts in (("init", init_counts), ("steady", steady_counts),
                         ("drift", drift_counts), ("train", train_counts)):
        if any(counts[k] for k in off_route):
            raise AssertionError(f"halo {what} launched a halo-free kernel: {_nonzero(counts)}")
    if (train_counts["gated_block_attention_fwd"] != layers
            or train_counts["gated_block_attention_bwd"] != layers):
        raise AssertionError(f"halo train step launches {_nonzero(train_counts)}")
    _grads_agree("config5 halo train: kernel vs plain route", gparams, gcfg, fpad, bdg,
                 state["keep"])
    say("config5_halo", nodes=H_NODES, nB=nb, B=b, T=bdg.table, k=H_K, k_within=H_K_IN,
        layout_s=round(layout_s, 3), gate_init_ms=init_ms,
        steady_ms=[round(t, 3) for t in steady_ms], drift_ms=[round(t, 3) for t in drift_ms],
        resolved_per_drift_step=drift_res, budget=budget, train_step_ms=train_ms,
        loss=float(loss))
    say("config5_halo_launches", init=_nonzero(init_counts), steady=_nonzero(steady_counts),
        drift=_nonzero(drift_counts), train=_nonzero(train_counts))
    h = gated._ln(gparams[0]["ln1"], fpad.reshape(nb, b, d)).contiguous()
    launches = {k: init_counts[k] + steady_counts[k] + drift_counts[k] + train_counts[k]
                for k in ("block_gate_signature_x", "gated_block_attention_fwd",
                          "gated_block_attention_bwd")}
    return dict(h=h, pad=bdg.node_pad, launches=launches)


def phase_contrastive(params, cfg, feats, graph) -> None:
    """The RuvectorLayer's contrastive train step (TrainConfig defaults:
    batch 256, 64 negatives, tau 0.07) with Adam (lr 1e-3) on the 100k-node
    graph: anchors and negatives drawn on the host outside the timed
    window; the losses must be finite and the parameters must move."""
    tcfg = TrainConfig()
    opt = adam(tcfg.learning_rate)
    step = make_train_step(cfg, opt, tcfg)
    gen = torch.Generator().manual_seed(0)
    p, state, times, losses = params, opt.init(params), [], []
    for _ in range(CONTRASTIVE_STEPS):
        anchors = torch.randperm(graph.num_nodes, generator=gen)[:tcfg.batch_size].int()
        negs = sample_negatives(gen, graph, anchors, tcfg.n_negatives)
        (p, state, loss), ms = _synced_ms(lambda: step(p, state, feats, graph, anchors.to(DEV),
                                                       negs.to(DEV)))
        times.append(ms)
        losses.append(float(loss))
    moved = max(float((a - b).abs().max()) for a, b in
                zip(_flat_dict(p), _flat_dict(params)))
    if not all(np.isfinite(losses)) or not moved > 0:
        raise AssertionError(f"contrastive step: losses {losses}, parameters moved {moved}")
    say("contrastive", nodes=graph.num_nodes, batch=tcfg.batch_size,
        negatives=tcfg.n_negatives, temperature=tcfg.temperature, lr=tcfg.learning_rate,
        optimizer="adam", step_ms=statistics.median(times),
        steps_ms=[round(t, 3) for t in times], losses=losses, max_param_move=moved)


def _flat_dict(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat_dict(tree[k])]
    return [tree]


def train_report(c5: dict, halo: dict, gparams, gcfg) -> list:
    """Report rows of the training kernels: K5a and K5b at the train
    step's shapes (layer 0's normalized input, init masks, every
    partition; a cotangent from a seed), K6b and K6a at the halo layout's
    (layer 0's normalized stream; q and k its bf16 projections)."""
    bdg, x0, keep0 = c5["bdg"], c5["x0"], c5["keep0"]
    nb, b, d = x0.shape
    hh = gcfg.num_heads
    p = gparams[0]
    h0 = gated._ln(p["ln1"], x0).contiguous()
    pad = bdg.node_pad
    A, Wvo = fold_gated_attention_params(p, gcfg)
    A_cat, Wvo_cat = head_concat(A), head_concat(Wvo)
    g = torch.randn(h0.shape, generator=torch.Generator(device=DEV).manual_seed(9), device=DEV)
    n = nb * b
    bf16, f32 = torch.bfloat16, torch.float32
    args = (h0, keep0, pad, A_cat, Wvo_cat)
    rows = [
        ("gated_block_attention_fwd",
         lambda: gated_block_attention_fwd(*args, compute_bf16=True),
         lambda: gated_block_attention_fwd_reference(*args, compute_bf16=True),
         _agree_as(bf16),
         bound(nbytes(*args) + nbytes(h0), {bf16: 2 * n * hh * (2 * d + 2 * b) * d}), {}),
        ("gated_block_attention_bwd",
         lambda: gated_block_attention_bwd(*args, g, compute_bf16=True),
         lambda: gated_block_attention_bwd_reference(*args, g, compute_bf16=True),
         lambda name, got, want: agree_grads(name, got, want, bf16),
         bound(nbytes(*args, g) + nbytes(h0, A_cat, Wvo_cat),
               {bf16: 2 * n * hh * (2 * d + b) * d, f32: 2 * n * hh * (4 * d + 4 * b) * d}),
         {})]
    hx, hpad = halo["h"], halo["pad"]
    hn, hb = hx.shape[0] * hx.shape[1], hx.shape[1]
    A_sig = gated._fold_sig_params(p, gcfg)
    q, k = gated._qk_proj(hx, p["wq"], p["wk"], gcfg)
    scale = 1.0 / (gcfg.head_dim ** 0.5) / hh
    sig_out = 2 * hn * 4
    rows.append(("block_gate_signature_x",
                 lambda: block_gate_signature_x(hx, hpad, A_sig, eps=gcfg.eps, compute_bf16=True),
                 lambda: block_gate_signature_x_reference(hx, hpad, A_sig, eps=gcfg.eps,
                                                          compute_bf16=True),
                 agree_rows, bound(nbytes(hx, hpad, A_sig) + sig_out,
                                   {bf16: 2 * hn * (hb + d) * d}),
                 {"shape": f"halo layout: nB={hx.shape[0]}, B={hb}"}))
    rows.append(("block_gate_signature",
                 lambda: block_gate_signature(q, k, hpad, eps=gcfg.eps, scale=scale),
                 lambda: block_gate_signature_reference(q, k, hpad, eps=gcfg.eps, scale=scale),
                 agree_rows, bound(nbytes(q, k, hpad) + sig_out, {bf16: 2 * hn * hb * d}),
                 {"shape": f"halo layout: nB={hx.shape[0]}, B={hb}, q/k bf16",
                  "path": OFF_PATH["block_gate_signature"]}))
    return rows


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    phase_build()

    d, k, heads = 128, 16, 4
    cfg = RuvectorLayerConfig(d, d, heads=heads, compute_dtype="bfloat16")
    params = ruvector_layer_init(0, cfg, device=DEV)
    phase_parity(params, cfg)
    # config 5: dim 128, 4 heads, FFN x4, 2 layers, lam 0.5, eps 0.01,
    # hysteresis band 0.05, budget nB/16, bf16 compute on f32 features
    gcfg = gated.GatedGraphTransformerConfig(
        dim=d, num_heads=heads, ffn_mult=4, num_layers=2, lam=0.5, eps=0.01,
        hysteresis_band=0.05, max_resolve_frac=1 / 16, compute_dtype="bfloat16")
    gparams = gated.gated_graph_transformer_init(0, gcfg, device=DEV)
    phase_gated_parity(gparams, gcfg)
    phase_train_parity(gparams, gcfg)

    # --- main path: the bench's headline route ------------------------------
    t0 = time.perf_counter()
    feats_np = bench_features(N_NODES, d)
    graph = build_knn_graph(feats_np, k=k, block=2048, device=DEV)
    torch.cuda.synchronize()
    t_knn = time.perf_counter() - t0
    idx = graph.nbr_idx.cpu().numpy()
    mask = graph.nbr_mask.cpu().numpy()
    ew = graph.edge_weight.cpu().numpy()
    t0 = time.perf_counter()
    perm, leaves = graph_grow_blocks(idx, mask, leaf_size=512)
    inv = np.empty(N_NODES, np.int64)
    inv[perm] = np.arange(N_NODES)
    bdg = build_block_dense(inv[idx[perm]].astype(np.int32), mask[perm], ew[perm],
                            leaf_sizes=leaves, dtype=torch.float32, device=DEV)
    t_layout = time.perf_counter() - t0
    edges = int(mask.sum())
    say("graph", nodes=N_NODES, k=k, edges=edges, knn_s=round(t_knn, 3),
        layout_s=round(t_layout, 3), nB=bdg.n_blocks, B=bdg.block, T=bdg.table,
        halo_ok=bdg.table <= 2 * bdg.block)
    fpad = bdg.pad_features(torch.from_numpy(feats_np[perm]).to(DEV))

    def main_path():
        x = fpad
        for _ in range(ITERS):
            x = ruvector_layer_apply_block_dense_fused(params, cfg, x, bdg)
        return x

    out, counts = counted(["block_dense_layer_fused"], main_path)
    launches = {"block_dense_layer_fused": counts["block_dense_layer_fused"]}
    if out.shape != fpad.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError("main path output is not finite or has the wrong shape")
    one = ruvector_layer_apply_block_dense_fused(params, cfg, fpad, bdg)
    scan = ruvector_layer_apply_block_dense(params, cfg, fpad, bdg)
    agree("main path: fused layer vs scan route", one, scan, torch.bfloat16)
    layer_ms = time_ms(lambda: ruvector_layer_apply_block_dense_fused(params, cfg, fpad, bdg),
                       iters=10)
    say("main_path", launches=launches["block_dense_layer_fused"], layer_ms=layer_ms,
        edges_per_s=edges / (layer_ms * 1e-3))

    # --- the other kernel routes on the same graph ---------------------------
    k2_out, counts = counted(["block_dense_attention"], lambda: ruvector_layer_apply_block_dense(
        params, cfg, fpad, bdg, use_pallas=True))
    launches["block_dense_attention"] = counts["block_dense_attention"]
    agree("K2 route vs scan route", k2_out, scan, torch.bfloat16)

    cfg32 = RuvectorLayerConfig(d, d, heads=heads)
    cfg_k3 = RuvectorLayerConfig(d, d, heads=heads, use_pallas=True)
    feats = torch.from_numpy(feats_np).to(DEV)
    k3_out, counts = counted(["fused_neighbor_mix"],
                             lambda: ruvector_layer_apply(params, cfg_k3, feats, graph))
    launches["fused_neighbor_mix"] = counts["fused_neighbor_mix"]
    agree("K3 route vs slot route", k3_out,
          ruvector_layer_apply(params, cfg32, feats, graph), torch.float32)

    net_cfg = RuvectorNetConfig(input_dim=d, hidden_dim=d, num_layers=2, heads=heads)
    net_out = ruvector_net_apply(ruvector_net_init(0, net_cfg, device=DEV), net_cfg,
                                 feats, graph)
    if net_out.shape != (N_NODES, d) or not bool(torch.isfinite(net_out).all()):
        raise AssertionError("RuvectorNet output is not finite or has the wrong shape")
    say("ruvector_net", layers=2, nodes=N_NODES, d=d, heads=heads, finite=True)

    # --- config 5: the gated graph transformer's serving path ---------------
    with torch.no_grad():
        c5 = phase_config5(gparams, gcfg, d)
    launches.update(c5["launches"])

    # --- training: config 5's train step, the halo layout, the contrastive step
    train_launches = phase_config5_train(gparams, gcfg, c5)
    c5_halo = phase_config5_halo(gparams, gcfg)
    launches["gated_block_layer"] += train_launches["gated_block_layer"]
    for name in ("gated_block_attention_fwd", "gated_block_attention_bwd",
                 "block_gate_signature_x"):
        launches[name] = train_launches.get(name, 0) + c5_halo["launches"][name]
    launches["block_gate_signature"] = 0
    phase_contrastive(params, cfg, feats, graph)

    # --- kernels at the main paths' shapes ------------------------------------
    report = []
    with torch.no_grad():
        # K1: the fused layer's own inputs
        msg = linear_apply(params["w_msg"], fpad)
        msgf = msg.reshape(bdg.n_blocks, bdg.block, d)
        halo = msg.to(cfg.cdt)[bdg.local_ids[:, bdg.block:].long()]
        L_tab = torch.cat([msgf.to(cfg.cdt), halo], dim=1).contiguous()
        folded = fold_layer_params(params, cfg)
        wd = bdg.wdense
        k1 = lambda: block_dense_layer_fused(L_tab, msgf, wd, folded, dropout=0.0,  # noqa: E731
                                             eps=cfg.eps)
        k1_ref = lambda: block_dense_layer_fused_reference(  # noqa: E731
            L_tab, msgf, wd, folded, dropout=0.0, eps=cfg.eps)
        n_edges = int((wd > 0).sum())
        rows = bdg.n_blocks * bdg.block
        ops = {cfg.cdt: 2 * (2 * heads + 1) * d * n_edges,
               torch.float32: 2 * (2 * heads + 7) * d * d * rows}
        report.append(("block_dense_layer_fused", k1, k1_ref, _agree_as(cfg.cdt),
                       bound(nbytes(L_tab, msgf, wd, *folded.values()) + nbytes(msgf), ops),
                       {}))

        # K2: the use_pallas block-dense route's inputs
        hd = d // heads
        q = linear_apply(params["attn"]["q"], msg).reshape(-1, heads, hd)
        wk = params["attn"]["k"]["kernel"].reshape(d, heads, hd)
        bk = params["attn"]["k"]["bias"].reshape(heads, hd)
        L_full = msg.to(cfg.cdt)[bdg.local_ids.long()].contiguous()
        u_hm = torch.einsum("nhf,dhf->hnd", q, wk).reshape(
            heads, bdg.n_blocks, bdg.block, d).to(cfg.cdt).contiguous()
        sb_hm = torch.einsum("nhf,hf->hn", q, bk).reshape(heads, bdg.n_blocks,
                                                          bdg.block).contiguous()
        k2 = lambda: block_dense_attention(L_full, u_hm, sb_hm, wd, scale=hd ** -0.5)  # noqa: E731
        k2_ref = lambda: block_dense_attention_reference(  # noqa: E731
            L_full, u_hm, sb_hm, wd, scale=hd ** -0.5)
        out_bytes = (heads + 1) * rows * d * 4
        report.append(("block_dense_attention", k2, k2_ref, _agree_as(cfg.cdt),
                       bound(nbytes(L_full, u_hm, sb_hm, wd) + out_bytes,
                             {cfg.cdt: 2 * (2 * heads + 1) * d * n_edges}), {}))

        # K3: the use_pallas slot route's inputs (f32 config)
        msg_s = linear_apply(params["w_msg"], feats)
        q_s = linear_apply(params["attn"]["q"], msg_s).reshape(-1, heads, hd)
        u_s = torch.einsum("nhf,dhf->nhd", q_s, wk).contiguous()
        bias_s = torch.einsum("nhf,hf->nh", q_s, bk).contiguous()
        nbr_s = msg_s[graph.nbr_idx.long()].contiguous()
        mask_s = graph.nbr_mask.contiguous()
        wnorm_s = normalized_weights(graph.edge_weight, graph.nbr_mask).contiguous()
        k3_args = (u_s, bias_s, nbr_s, mask_s, wnorm_s)
        k3 = lambda: fused_neighbor_mix(*k3_args, heads=heads, scale=hd ** -0.5)  # noqa: E731
        k3_ref = lambda: fused_neighbor_mix_reference(  # noqa: E731
            *k3_args, heads=heads, scale=hd ** -0.5)
        k3_ops = {torch.float32: 2 * (2 * heads + 1) * d * int((mask_s > 0).sum())}
        report.append(("fused_neighbor_mix", k3, k3_ref, _agree_as(torch.float32),
                       bound(nbytes(*k3_args) + (heads + 1) * N_NODES * d * 4, k3_ops),
                       {}))
        report += config5_report(c5, gparams, gcfg)
        report += train_report(c5, c5_halo, gparams, gcfg)

        lines = []
        for name, fn, ref, check, (bound_ms, bound_by), extra in report:
            err = check(f"{name} at main-path shapes", fn(), ref())
            ms = time_ms(fn, iters=10)
            plain_ms = time_ms(ref, iters=2, warmup=1)
            source, replaces = SOURCES[name]
            if launches[name] < 1 and name not in OFF_PATH:
                raise AssertionError(f"{name} was not launched on its path")
            lines.append({"name": name, "route": "cuda", "source": source,
                          "replaces": replaces, "launches": launches[name],
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                          **extra})
            say("kernel", name=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, **extra)
    say("done", seconds=round(time.perf_counter() - t_start, 1),
        peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2))
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
