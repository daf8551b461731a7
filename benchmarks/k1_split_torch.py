"""Where K1's time goes on the card: the fused RuvectorLayer's tensor-core
body timed over head counts H and table lengths T at the main path's other
widths (nB = 214 blocks of B = 512 rows, D = 128, bf16 compute, 16 edges
a row), and a least-squares split of its time into the part that grows
with H and T, the dense tile (u_h L^T, p L and wd L on bf16 tensor cores),
and the part that does not grow with T, the float32-grade epilogue (M A_h,
tv_h Wvo_h per head, then Wagg, w3, u2 and uhk as 3xTF32):

    ms(H, T) ~ a + H p + T (H q + r)

a + H p is the epilogue and its fixed costs, T (H q + r) the passes over
the table (r T the wd pass, which reads wd once). Inputs are random from
seed 0. Needs a CUDA card and nvcc:

    python3 benchmarks/k1_split_torch.py
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ruvector_tpu_torch.ops.kernels import _lib  # noqa: E402
from ruvector_tpu_torch.ops.kernels.block_dense_attn import (  # noqa: E402
    _folded_shapes,
    block_dense_layer_fused,
    k1_body,
)

NB, B, D, EDGES = 214, 512, 128, 16
POINTS = [(1, 512), (2, 512), (4, 512), (8, 512), (4, 256), (4, 1024), (1, 256), (1, 1024)]


def inputs(heads: int, t: int, dev):
    g = torch.Generator().manual_seed(0)
    cols = torch.randint(0, t, (NB, B, EDGES), generator=g)
    wd = torch.zeros(NB, B, t)
    wd.scatter_(2, cols, torch.rand(NB, B, EDGES, generator=g) + 0.05)
    wd = wd / wd.sum(-1, keepdim=True)
    L = torch.randn(NB, t, D, generator=g).to(torch.bfloat16)
    msg = torch.randn(NB, B, D, generator=g)
    folded = {k: torch.randn(s, generator=g) / D ** 0.5
              for k, s in _folded_shapes(heads, D).items()}
    return (L.to(dev), msg.to(dev), wd.to(dev), {k: v.to(dev) for k, v in folded.items()})


def time_ms(fn, iters: int = 10) -> float:
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
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _lib.build(("block_dense_attn",))
    dev = torch.device("cuda")
    rows = []
    for heads, t in POINTS:
        L, msg, wd, folded = inputs(heads, t, dev)
        assert k1_body(L.dtype) == "tensor_core"
        ms = time_ms(lambda: block_dense_layer_fused(L, msg, wd, folded, dropout=0.0,  # noqa: B023
                                                     eps=1e-5))
        rows.append((heads, t, ms))
        print(f"[k1_point] H={heads} T={t} ms={ms}", flush=True)
        del L, msg, wd, folded
    X = np.array([[1.0, h, t * h, t] for h, t, _ in rows])
    y = np.array([ms for _, _, ms in rows])
    (a, p, q, r), *_ = np.linalg.lstsq(X, y, rcond=None)
    fit = X @ np.array([a, p, q, r])
    print(f"[k1_fit] a={a} p={p} q={q} r={r} max_residual_ms={float(np.abs(fit - y).max())}")
    for heads, t in ((4, 512),):
        print(f"[k1_split] H={heads} T={t} ms_model={a + heads * p + t * (heads * q + r)} "
              f"epilogue_ms={a + heads * p} head_passes_ms={t * heads * q} wd_pass_ms={t * r} "
              f"wd_bytes_ms={NB * B * t * 4 / 3.35e12 * 1e3}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
