"""Personalized PageRank: forward and backward push, power iteration and
random walks (port of ruvector_tpu/solver/push.py).

The push is the vectorized form of the JAX package: every node pushes its
residual at once in each sweep (x += alpha r; r' = (1 - alpha) P^T r,
P = D^-1 A), a host loop that reads the largest degree-scaled residual
after each sweep. Functions return tensors on the graph's device. The
random walks draw their uniforms from a seeded CPU generator and move
them to the device, so a seed gives the same walks on every device; they
do not reproduce `jax.random`'s draws, only the estimator; the visit
counts are divided by the walks exactly (`true_div`), so the estimate is
the same on every device too.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.graph.csr import CSRGraph
from ruvector_tpu_torch.ops.quantization import true_div
from ruvector_tpu_torch.ops.segment import _segment_sum


def _degrees(graph: CSRGraph) -> torch.Tensor:
    return torch.clamp(graph.degrees().to(torch.float32), min=1.0)


def _degree_normalized_transpose_spmv(graph: CSRGraph, r: torch.Tensor) -> torch.Tensor:
    """y = P^T r with P = D^-1 A: each edge (u -> v) carries r[u]/deg(u)
    to v."""
    rows = graph.row_ids().long()
    return _segment_sum((r / _degrees(graph))[rows], graph.col_idx.long(), graph.num_nodes)


def _seed_vector(graph: CSRGraph, node: int) -> torch.Tensor:
    seed = torch.zeros(graph.num_nodes, dtype=torch.float32, device=graph.row_ptr.device)
    seed[node] = 1.0
    return seed


def _push_sweeps(graph: CSRGraph, seed_vec: torch.Tensor, alpha: float, epsilon: float,
                 max_sweeps: int):
    deg = _degrees(graph)
    x, r, k = torch.zeros_like(seed_vec), seed_vec, 0
    while k < max_sweeps and float(torch.max(torch.abs(r) / deg)) > epsilon:
        x = x + alpha * r
        r = (1.0 - alpha) * _degree_normalized_transpose_spmv(graph, r)
        k += 1
    return x, r, k


def forward_push_ppr(graph: CSRGraph, source: int, alpha: float = 0.15,
                     epsilon: float = 1e-4, max_sweeps: int = 100) -> torch.Tensor:
    """PPR vector from a source node (forward_push.rs:108-240 semantics:
    push until every residual is below eps * deg)."""
    x, _, _ = _push_sweeps(graph, _seed_vector(graph, source), alpha, epsilon, max_sweeps)
    return x


def _reverse_graph(graph: CSRGraph) -> CSRGraph:
    """The graph with every edge reversed (built on the host, on the
    graph's device)."""
    return CSRGraph.from_edges(graph.col_idx.cpu().numpy(), graph.row_ids().cpu().numpy(),
                               graph.values.cpu().numpy(), graph.num_nodes,
                               device=graph.row_ptr.device)


def backward_push_ppr(graph: CSRGraph, target: int, alpha: float = 0.15,
                      epsilon: float = 1e-4, max_sweeps: int = 100) -> torch.Tensor:
    """PPR contribution TO a target (backward_push.rs:143): forward push
    on the reverse graph."""
    rev = _reverse_graph(graph)
    x, _, _ = _push_sweeps(rev, _seed_vector(graph, target), alpha, epsilon, max_sweeps)
    return x


def ppr_power_iteration(graph: CSRGraph, source: int, alpha: float = 0.15,
                        iters: int = 50) -> torch.Tensor:
    """Dense power-iteration PPR, the convergence oracle for push and walks."""
    seed = _seed_vector(graph, source)
    x = seed
    for _ in range(iters):
        x = alpha * seed + (1 - alpha) * _degree_normalized_transpose_spmv(graph, x)
    return x


def random_walk_ppr(graph: CSRGraph, source: int, alpha: float = 0.15,
                    num_walks: int = 1000, max_len: int = 50, seed: int = 0) -> torch.Tensor:
    """Monte-Carlo PPR (random_walk.rs:135+): alpha-terminating walks from
    the source, all advancing in lockstep; the estimate is the
    distribution of the walks' end points. Deterministic given (seed,
    shapes), and the same on every device."""
    dev = graph.row_ptr.device
    n, e = graph.num_nodes, graph.num_edges
    row_ptr, col_idx = graph.row_ptr.long(), graph.col_idx.long()
    deg = graph.degrees().long()
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    draws = torch.rand((max_len, 2, num_walks), generator=gen).to(dev)
    pos = torch.full((num_walks,), int(source), dtype=torch.long, device=dev)
    stopped = torch.zeros(num_walks, dtype=torch.bool, device=dev)
    for step in range(max_len):
        stop_now = draws[step, 0] < alpha
        d = deg[pos]
        # a uniform out-edge; dead ends stop the walk
        offset = (draws[step, 1] * torch.clamp(d, min=1).to(torch.float32)).to(torch.long)
        edge = row_ptr[pos] + torch.minimum(offset, torch.clamp(d - 1, min=0))
        nxt = col_idx[torch.clamp(edge, max=max(e - 1, 0))]
        halt = stopped | stop_now | (d == 0)
        pos = torch.where(halt, pos, nxt)
        stopped = halt
    counts = torch.zeros(n, dtype=torch.float32, device=dev)
    counts.index_add_(0, pos, torch.ones(num_walks, dtype=torch.float32, device=dev))
    return true_div(counts, num_walks)
