#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (ruvector_tpu_torch).

Builds the CUDA kernels from `ruvector_tpu_torch/csrc/`, holds each kernel
against its plain PyTorch version, then drives the port's main path on
one card at the bench's headline width: a clustered 100k-node, 128-d
feature set (bench.py's data, seed 0), its k=16 cosine kNN graph built on
the card, graph-grown 512-node blocks, and the block-dense RuvectorLayer
(d=128, 4 heads, bf16 compute) as the fused kernel, applied a few times
to its own output. The other kernel routes (block-dense attention, slot
neighbor-mix) and the 2-layer RuvectorNet run on the same graph.

Prints one line per phase, the card's name and power limit, a `kernels`
JSON line (launches on the main path, error against the plain version,
times on the card, the least time the card could take), and as the last
line `{"ok": true, "device": {...}}`. Any failed phase exits non-zero
before that line; so does a run without a CUDA card or without the
package beside this script.

    python3 chip_smoke.py
"""

from __future__ import annotations

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
}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def agree(name: str, got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype) -> float:
    """Max abs error of got against want; raises beyond the tolerance."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
                             f"or non-finite output")
    err = (got - want).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    tol_max, tol_mean = TOL[dtype]
    ok = max_err <= tol_max and mean_err <= tol_mean
    say("agree", name=name, dtype=str(dtype).replace("torch.", ""), max_abs_err=max_err,
        mean_abs_err=mean_err, tol_max=tol_max, tol_mean=tol_mean, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: disagrees with its reference")
    return max_err


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


def main() -> int:
    t_start = time.perf_counter()
    phase_device()
    phase_build()

    d, k, heads = 128, 16, 4
    cfg = RuvectorLayerConfig(d, d, heads=heads, compute_dtype="bfloat16")
    params = ruvector_layer_init(0, cfg, device=DEV)
    phase_parity(params, cfg)

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

    # --- kernels at the main path's shapes ------------------------------------
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
        report.append(("block_dense_layer_fused", k1, k1_ref,
                       bound(nbytes(L_tab, msgf, wd, *folded.values()) + nbytes(msgf), ops),
                       cfg.cdt))

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
        report.append(("block_dense_attention", k2, k2_ref,
                       bound(nbytes(L_full, u_hm, sb_hm, wd) + out_bytes,
                             {cfg.cdt: 2 * (2 * heads + 1) * d * n_edges}), cfg.cdt))

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
        report.append(("fused_neighbor_mix", k3, k3_ref,
                       bound(nbytes(*k3_args) + (heads + 1) * N_NODES * d * 4, k3_ops),
                       torch.float32))

        lines = []
        for name, fn, ref, (bound_ms, bound_by), dtype in report:
            err = agree(f"{name} at main-path shapes", fn(), ref(), dtype)
            ms = time_ms(fn, iters=20)
            plain_ms = time_ms(ref, iters=3, warmup=1)
            source, replaces = SOURCES[name]
            lines.append({"name": name, "route": "cuda", "source": source,
                          "replaces": replaces, "launches": launches[name],
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
            say("kernel", name=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)
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
