"""The benchmark's data: clustered node features and their exact
within-cluster kNN graph, made on the device from a seed, and the fresh
draws that move the features step by step.

`cluster_graph` is a frozen copy of chip_smoke.py's (config 5's data,
benchmarks/scale_sweep_r02.py:82-94), with the cluster size and the
device as arguments and its generator seeded from the run's seed.
"""

from __future__ import annotations

import torch

# seed streams: each draw of a run has a generator of its own, seeded from
# the run's seed and the draw's tag, so that any draw can be made again
_MIX = 0x9E3779B97F4A7C15
TAG_GRAPH, TAG_WEIGHTS, TAG_SAMPLE = 1, 2, 3
TAG_DRAW = 1000          # + the step's index (warm-up steps are negative)


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for stream `tag` of run `seed` (any whole number)."""
    return ((int(seed) % (1 << 64)) * _MIX + tag * 0xBF58476D1CE4E5B9) % (1 << 63)


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def cluster_graph(n: int, d: int, k: int, cluster: int, seed: int, device, chunk: int = 512):
    """Clusters of `cluster` points around N(0, 1) centres with std 0.25,
    contiguous, and the exact within-cluster kNN (self excluded) with
    weights 1/(1 + dist). Returns (feats [n, d] float32, idx [n, k] int32,
    ew [n, k] float32), on `device`."""
    if n % cluster:
        raise ValueError(f"{n} nodes are not whole clusters of {cluster}")
    gen = generator(seed, TAG_GRAPH, device)
    nc = n // cluster
    feats = torch.empty(n, d, device=device)
    idx = torch.empty(n, k, dtype=torch.int32, device=device)
    ew = torch.empty(n, k, device=device)
    self_pair = 1e30 * torch.eye(cluster, device=device)
    for s in range(0, nc, chunk):
        c = min(chunk, nc - s)
        pts = (torch.randn(c, 1, d, generator=gen, device=device)
               + 0.25 * torch.randn(c, cluster, d, generator=gen, device=device))
        sq = (pts * pts).sum(-1)
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(pts, pts.transpose(1, 2))
        neg, nn_idx = torch.topk(-(d2 + self_pair), k, dim=-1)
        rows = slice(s * cluster, (s + c) * cluster)
        feats[rows] = pts.reshape(-1, d)
        base = torch.arange(s, s + c, device=device, dtype=torch.int32)[:, None, None] * cluster
        idx[rows] = (nn_idx.int() + base).reshape(-1, k)
        ew[rows] = (1.0 / (1.0 + torch.sqrt(torch.clamp(-neg, min=0.0)))).reshape(-1, k)
    return feats, idx, ew


def drifted(base: torch.Tensor, sigma: float, seed: int, step: int) -> torch.Tensor:
    """The features of step `step`: base plus a fresh sigma N(0, 1) draw of
    base's shape and dtype (not a running sum, so every step does the same
    work); the same seed and step give the same tensor."""
    gen = generator(seed, TAG_DRAW + step, base.device)
    noise = torch.randn(base.shape, generator=gen, device=base.device, dtype=base.dtype)
    return torch.add(base, noise, alpha=sigma)
