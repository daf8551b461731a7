#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (ruvector_tpu_torch).

Builds the CUDA kernels from `ruvector_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version, then drives the port's two paths on
one card:

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
    block_gate_signature_ln_x,
    block_gate_signature_ln_x_reference,
    layer_norm_rows,
    matmul_f64,
    pack_keep,
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
}
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
    """Gate-signature rows (rsum, rcnt) of x against the plain version on
    x. The kernel's LayerNorm is the plain one step for step, and the
    logits' sums are float64 in both (exact for bf16 products), so the
    counts must be equal; the row sums (float64, rounded once) within
    1e-6 relative. Returns the max abs error of rsum."""
    rsum, rcnt = got
    wsum, wcnt = block_gate_signature_ln_x_reference(x, pad, *sig, eps=eps,
                                                     compute_bf16=compute_bf16)
    if rsum.shape != wsum.shape or not bool(torch.isfinite(rsum).all()):
        raise AssertionError(f"{name}: wrong shape or non-finite output")
    counts_equal = torch.equal(rcnt, wcnt)
    sums_close = bool(torch.allclose(rsum, wsum, rtol=1e-6, atol=0.0))
    say("agree", name=name, rows=rcnt.numel(), counts_equal=counts_equal,
        count_diffs=float((rcnt - wcnt).abs().sum()), sums_equal=torch.equal(rsum, wsum),
        sums_close=sums_close, sums_rtol=1e-6, ok=counts_equal and sums_close)
    if not (counts_equal and sums_close):
        raise AssertionError(f"{name}: disagrees with its reference")
    return float((rsum - wsum).abs().max())


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
    return dict(bdg=bdg, x0=x0, keep0=keep0, x_sel=f_drift.reshape(nb, b, d)[sel].contiguous(),
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

        lines = []
        for name, fn, ref, check, (bound_ms, bound_by), extra in report:
            err = check(f"{name} at main-path shapes", fn(), ref())
            ms = time_ms(fn, iters=10)
            plain_ms = time_ms(ref, iters=2, warmup=1)
            source, replaces = SOURCES[name]
            if launches[name] < 1:
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
