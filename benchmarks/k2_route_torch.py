"""The RuvectorLayer's K2 route on the card, at the bench's headline shape.

Builds `chip_smoke.py`'s main-path graph (100k clustered nodes, bench.py's
data at seed 0, k=16 cosine kNN on the card, graph-grown 512-node blocks)
and times one layer (d=128, 4 heads, bf16 compute, weights from seed 0)
through the block-dense route with its kernel, K2
(`ruvector_layer_apply_block_dense(..., use_pallas=True)`), and through
the fused route, K1, each the median of 10 calls (CUDA events). It imports
the package beside it, so a copy of the script placed in an older
checkout's `benchmarks/` times that checkout's kernels:

    python3 benchmarks/k2_route_torch.py
"""
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ruvector_tpu_torch.graph import build_block_dense, build_knn_graph  # noqa: E402
from ruvector_tpu_torch.nn.block_dense_layer import (  # noqa: E402
    ruvector_layer_apply_block_dense,
    ruvector_layer_apply_block_dense_fused,
)
from ruvector_tpu_torch.nn.ruvector_layer import (  # noqa: E402
    RuvectorLayerConfig,
    ruvector_layer_init,
)
from ruvector_tpu_torch.parallel.ordering import graph_grow_blocks  # noqa: E402

N, D, K, HEADS, LEAF = 100_000, 128, 16, 4, 512


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k2_route_torch: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)  # bench.py's clustered data
    centers = rng.normal(size=(1000, D)).astype(np.float32)
    feats = (centers[rng.integers(0, 1000, size=N)]
             + 0.25 * rng.normal(size=(N, D))).astype(np.float32)
    graph = build_knn_graph(feats, k=K, block=2048, device=dev)
    idx, mask = graph.nbr_idx.cpu().numpy(), graph.nbr_mask.cpu().numpy()
    ew = graph.edge_weight.cpu().numpy()
    perm, leaves = graph_grow_blocks(idx, mask, leaf_size=LEAF)
    inv = np.empty(N, np.int64)
    inv[perm] = np.arange(N)
    bdg = build_block_dense(inv[idx[perm]].astype(np.int32), mask[perm], ew[perm],
                            leaf_sizes=leaves, dtype=torch.float32, device=dev)
    fpad = bdg.pad_features(torch.from_numpy(feats[perm]).to(dev))
    cfg = RuvectorLayerConfig(D, D, heads=HEADS, compute_dtype="bfloat16")
    params = ruvector_layer_init(0, cfg, device=dev)
    with torch.no_grad():
        k2_route = time_ms(lambda: ruvector_layer_apply_block_dense(params, cfg, fpad, bdg,
                                                                    use_pallas=True))
        fused = time_ms(lambda: ruvector_layer_apply_block_dense_fused(params, cfg, fpad, bdg))
    edges = int(mask.sum())
    print(json.dumps({"card": smi, "checkout": str(Path(__file__).resolve().parents[1]),
                      "nB": bdg.n_blocks, "B": bdg.block, "T": bdg.table, "edges": edges,
                      "k2_route_ms": k2_route, "fused_route_ms": fused}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
