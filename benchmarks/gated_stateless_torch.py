#!/usr/bin/env python3
"""The stateless gated graph transformer's cost on the card, one process.

Times `gated_graph_transformer_apply` without autograd (inference) and
`gated_graph_transformer_loss` with its backward (training) at config 5's
width (dim 128, 4 heads, FFN x4, 2 layers, B = 256, bf16 compute, random
weights from seed 0) on config 5's data (chip_smoke.cluster_graph) cut to
one rank's share of the 999,936-node layout: 977 partitions of 256, the
first rank's run in chip_smoke.py's `[parallel]` phase. Prints the card's
name and power limit, then one JSON object: the median ms of each (CUDA
events, after one warm-up call), each one's peak device memory, and the
output's and gradients' checksums, so that two trees can be held against
each other.

    python3 benchmarks/gated_stateless_torch.py [--root TREE] [--iters N]

`--root` takes `chip_smoke` and `ruvector_tpu_torch` from another checkout
(for example the parent commit unpacked by `git archive`); the default is
the checkout that holds this script. Needs one CUDA card; the stateless
route launches no hand-written kernel, so nothing is built.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

BLOCKS = 977


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    import chip_smoke as cs
    from ruvector_tpu_torch.graph import build_block_dense
    from ruvector_tpu_torch.graph_transformer import gated

    if not torch.cuda.is_available():
        raise SystemExit("gated_stateless_torch: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    n = BLOCKS * cs.C5_BLOCK
    feats, idx, ew = cs.cluster_graph(n, 128, cs.C5_K)
    bdg = build_block_dense(idx.cpu().numpy(), np.ones((n, cs.C5_K), np.float32),
                            ew.cpu().numpy(), block=cs.C5_BLOCK, device=dev)
    fpad = bdg.pad_features(feats)
    zeros = torch.zeros_like(fpad)
    cfg = cs.config5_config(128, 4)
    params = gated.gated_graph_transformer_init(0, cfg, device=dev)
    leaves = [t for layer in params for t in gated._flatten(layer)[1]]

    def infer():
        with torch.no_grad():
            return gated.gated_graph_transformer_apply(params, cfg, fpad, bdg)

    def train():
        for t in leaves:
            t.requires_grad_(True)
        loss = gated.gated_graph_transformer_loss(params, cfg, fpad, bdg, zeros)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        return loss.detach(), grads

    def timed(fn):
        out = fn()
        times = []
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(args.iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize(dev)
            times.append(a.elapsed_time(b))
        return out, float(np.median(times)), torch.cuda.max_memory_allocated(dev)

    out, infer_ms, infer_peak = timed(infer)
    (loss, grads), train_ms, train_peak = timed(train)
    print(json.dumps(dict(
        root=os.path.abspath(args.root), blocks=BLOCKS, nodes=n, iters=args.iters,
        infer_ms=infer_ms, infer_peak_bytes=infer_peak, train_ms=train_ms,
        train_peak_bytes=train_peak, out_sum=float(out.double().sum()),
        out_abs_sum=float(out.double().abs().sum()), loss=float(loss),
        grad_abs_sums=[float(g.double().abs().sum()) for g in grads])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
