"""Where K2's and K3's time goes on the card, at the main paths' widths.

K2 (block-dense attention, bf16 compute, its tensor-core body): nB = 214
blocks of B = 512 rows, D = 128, 16 edges a row, timed over head counts
H at T = 512 and over T at H = 4, with a least-squares split

    ms(H, T) ~ a + T (H q + r)

into the wd pass (r T: wd read once, wd L, out[H] written) and the head
passes (H q T: u_h L^T, the online softmax, p L, out[h] written). The
edges of a row are spread over the whole table there, so every 64-row
chunk of the table holds an edge of every 16-row strip; one more point at
H = 4, T = 512 keeps a row's edges within 128 columns of its own (a
graph-grown layout's locality), where a warp skips the chunks without an
edge of its strip.

K3 (the slot layout's neighbor mix, float32): N = 100,000 nodes, M = 16
slots, D = 128, H = 4 (the K3 route's shape), both bodies on the same
inputs in one process: "streaming" (the one the wrapper picks there) and
"warp" (launched through the library's entry point), each beside the
bytes bound.

Inputs are random from seed 0. Needs a CUDA card and nvcc:

    python3 benchmarks/k2_k3_torch.py
"""
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ruvector_tpu_torch.ops.kernels import _lib  # noqa: E402
from ruvector_tpu_torch.ops.kernels.block_dense_attn import (  # noqa: E402
    block_dense_attention,
    k2_body,
)
from ruvector_tpu_torch.ops.kernels.neighbor_mix import (  # noqa: E402
    fused_neighbor_mix,
    k3_body,
)

NB, B, D, EDGES = 214, 512, 128, 16
K2_POINTS = [(1, 512), (2, 512), (4, 512), (8, 512), (4, 256), (4, 1024)]
N, M, HEADS = 100_000, 16, 4
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def time_ms(fn, iters: int = 10) -> float:
    """Median milliseconds of one call (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def k2_inputs(heads: int, t: int, dev, band: int = 0):
    g = torch.Generator().manual_seed(0)
    if band:  # row r's edges in columns [base, base + band) around r
        base = (torch.arange(B) - band // 2).clamp(0, t - band)[None, :, None]
        cols = base + torch.randint(0, band, (NB, B, EDGES), generator=g)
    else:
        cols = torch.randint(0, t, (NB, B, EDGES), generator=g)
    wd = torch.zeros(NB, B, t)
    wd.scatter_(2, cols, torch.rand(NB, B, EDGES, generator=g) + 0.05)
    wd = wd / wd.sum(-1, keepdim=True)
    L = torch.randn(NB, t, D, generator=g).to(torch.bfloat16)
    u = (0.1 * torch.randn(heads, NB, B, D, generator=g)).to(torch.bfloat16)
    sb = torch.randn(heads, NB, B, generator=g)
    return L.to(dev), u.to(dev), sb.to(dev), wd.to(dev)


def k2_split(dev) -> dict:
    rows = []
    for heads, t in K2_POINTS:
        L, u, sb, wd = k2_inputs(heads, t, dev)
        ms = time_ms(lambda: block_dense_attention(L, u, sb, wd, scale=0.25))
        rows.append((heads, t, ms))
        print(f"[k2] H={heads} T={t} ms={ms:.4f}", flush=True)
        del L, u, sb, wd
    A = np.array([[1.0, t * h, t] for h, t, _ in rows])
    y = np.array([ms for _, _, ms in rows])
    (a, q, r), *_ = np.linalg.lstsq(A, y, rcond=None)
    resid = float(np.abs(A @ np.array([a, q, r]) - y).max())
    split = {"fixed_ms": float(a), "head_pass_ms_at_T512": float(q * 512),
             "wd_pass_ms_at_T512": float(r * 512), "max_residual_ms": resid}
    print(f"[k2_split] {json.dumps(split)}", flush=True)
    L, u, sb, wd = k2_inputs(4, 512, dev, band=128)
    banded = time_ms(lambda: block_dense_attention(L, u, sb, wd, scale=0.25))
    print(f"[k2] H=4 T=512 edges within 128 columns ms={banded:.4f}", flush=True)
    return {"body": k2_body(torch.bfloat16), "points": rows, "split": split,
            "banded_128_ms": banded}


def k3_bodies(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    u, bias, nbr = (torch.randn(s, generator=g).to(dev)
                    for s in ((N, HEADS, D), (N, HEADS), (N, M, D)))
    mask = (torch.rand(N, M, generator=g) > 0.1).float().to(dev)
    wnorm = torch.rand(N, M, generator=g).to(dev) * mask
    out = torch.empty(N, HEADS + 1, D, device=dev)
    n_bytes = 4 * (u.numel() + bias.numel() + nbr.numel() + 2 * mask.numel() + out.numel())
    bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    lib = _lib.load("neighbor_mix")
    stream = _lib.stream_handle(u)

    def warp():
        rc = lib.neighbor_mix_f32(u.data_ptr(), bias.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                                  wnorm.data_ptr(), out.data_ptr(), N, HEADS, M, D, 0, 0, 0.25,
                                  stream)
        _lib.check(lib, rc, "neighbor_mix_f32 (warp body)")

    res = {"bound_ms": bound_ms, "picked": k3_body(HEADS, M, D)}
    warp()
    want = out.clone()
    got = fused_neighbor_mix(u, bias, nbr, mask, wnorm, heads=HEADS, scale=0.25)
    res["max_abs_diff_between_bodies"] = float((got - want).abs().max())
    for name, fn in (("warp", warp), ("streaming", lambda: fused_neighbor_mix(
            u, bias, nbr, mask, wnorm, heads=HEADS, scale=0.25)), ("warp_again", warp)):
        ms = time_ms(fn)
        res[f"{name}_ms"] = ms
        print(f"[k3] body={name} ms={ms:.4f} bound_ms={bound_ms:.4f} "
              f"share_of_bound={bound_ms / ms:.3f}", flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k2_k3_torch: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _lib.build(("block_dense_attn", "neighbor_mix"))
    dev = torch.device("cuda")
    print(json.dumps({"card": smi, "k2": k2_split(dev), "k3": k3_bodies(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
