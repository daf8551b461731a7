#!/usr/bin/env python3
"""Config 5 at 10M nodes on the straight routes, on the card.

Builds `chip_smoke.py`'s `[config5_10m]` graph and model (9,999,872 nodes
in clusters of 128 made on the card, 39,062 halo-free partitions of 256,
bf16 features, edge table and compute, random weights from seed 0), then
with every route of `graph_transformer/gated.py` straight
(`gated._CHUNK_NB` above nB; a tree without the chunked routes takes the
straight routes at any nB) runs gate_state_init, one train step (the loss
under the state's masks with remat and its gradient, config5_r03.py's
protocol) and then one serving step. Prints the card's name and power
limit, then one JSON line a part: its ms and peak device memory, or where
it ran out of the card's memory: the bytes the failed allocation asked
for, the allocator's message and the innermost frame of the port.

    python3 benchmarks/config5_10m_straight_torch.py [--root TREE]

`--root` takes `chip_smoke` and `ruvector_tpu_torch` from another
checkout (for example the parent commit unpacked by `git archive`); the
default is the checkout that holds this script. Needs one CUDA card;
builds config 5's four kernel sources.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import time
import traceback

NODES = 9_999_872


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from ruvector_tpu_torch.graph import build_block_dense
    from ruvector_tpu_torch.graph_transformer import gated
    from ruvector_tpu_torch.ops.kernels import _lib

    if not torch.cuda.is_available():
        raise SystemExit("config5_10m_straight_torch: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sources = ("gated_block_layer", "gated_block_attn", "gated_block_mha", "mincut_gate_block")
    print(json.dumps({"build_s": _lib.build(sources)}), flush=True)
    gated._CHUNK_NB = sys.maxsize      # straight everywhere (no effect on a tree without it)

    feats, idx, ew = cs.cluster_graph(NODES, 128, cs.C5_K)
    feats = feats.to(torch.bfloat16)
    bdg = build_block_dense(idx.cpu().numpy(), np.ones((NODES, cs.C5_K), np.float32),
                            ew.cpu().numpy(), block=cs.C5_BLOCK, dtype=torch.bfloat16,
                            device=dev)
    del idx, ew
    fpad = bdg.pad_features(feats)
    del feats
    cfg = cs.config5_config(128, 4)
    params = gated.gated_graph_transformer_init(0, cfg, device=dev)
    kept = {}

    def part(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        row = {"part": name, "root": root, "nodes": NODES, "nB": bdg.n_blocks,
               "straight": True}
        try:
            kept[name] = fn()
            torch.cuda.synchronize()
            row.update(ms=(time.perf_counter() - t0) * 1e3, out_of_memory=False)
        except torch.cuda.OutOfMemoryError as e:
            msg = str(e)
            asked = re.search(r"Tried to allocate ([\d.]+ [KMG]iB)", msg)
            frames = [f for f in traceback.extract_tb(e.__traceback__)
                      if "ruvector_tpu_torch" in f.filename]
            where = frames[-1] if frames else None
            row.update(out_of_memory=True, asked=asked.group(1) if asked else None,
                       where=None if where is None else
                       f"{os.path.relpath(where.filename, root)}:{where.lineno} {where.name}",
                       code=None if where is None else where.line,
                       message=msg.splitlines()[0][:600])
            del e
        row.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   allocated_gb=torch.cuda.memory_allocated() / 1e9)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    def train():
        leaves = [t.detach().requires_grad_(True) for t in cs._leaves(params)]
        loss = gated.gated_graph_transformer_loss_with_masks(
            cs._rebuild(params, leaves), dataclasses.replace(cfg, remat=True), fpad, bdg,
            kept["init"]["keep"], torch.zeros_like(fpad))
        grads = torch.autograd.grad(loss, leaves)
        return float(loss), [float(g.float().abs().max()) for g in grads]

    def serve():
        with torch.no_grad():
            out, _, nres = gated.gated_graph_transformer_step(params, cfg, fpad, bdg, kept["init"])
            return float(out.float().abs().max()), nres

    with torch.no_grad():
        part("init", lambda: gated.gate_state_init(params, cfg, fpad, bdg))
    part("train", train)
    part("serve", serve)
    return 0


if __name__ == "__main__":
    sys.exit(main())
