"""chip_smoke.py's `[attention_rest]` and `[quantization]` phases alone,
on the card, without the kernel build (neither phase launches a kernel).

Makes the main path's 100k-node, 128-d features and their k=16 kNN graph
as chip_smoke.py's main() does, then runs the phases named on the command
line (both by default) and prints the peak device memory.

    python3 benchmarks/attention_quantization_torch.py [attn] [quant]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    cs.phase_device()
    torch.cuda.reset_peak_memory_stats()
    which = sys.argv[1:] or ["attn", "quant"]
    if "attn" in which:
        feats_np = cs.bench_features(cs.N_NODES, 128)
        graph = cs.build_knn_graph(feats_np, k=16, block=2048, device=cs.DEV)
        cs.phase_attention_rest(torch.from_numpy(feats_np).to(cs.DEV), graph, 128)
    if "quant" in which:
        cs.phase_quantization(128)
    cs.say("done", seconds=round(time.perf_counter() - t0, 1),
           peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
