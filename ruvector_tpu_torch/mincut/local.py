"""Local clustering: Andersen-Chung-Lang PPR sweep cuts (port of
ruvector_tpu/mincut/local.py).

Reference: ruvector-mincut/src/localkcut — local k-cut around seed
vertices without touching the whole graph. The classical algorithm with
the same contract is ACL local clustering: an approximate personalized-
PageRank vector from the seed (solver/push — already a device-vectorized
sweep) followed by a sweep over nodes ordered by ppr/degree, returning
the prefix with minimum conductance. Work is local in the push phase and
O(support log support) in the sweep.

The graph's CSR tensors may live on the card: each function reads them
to the host once per call; the PPR push runs on the graph's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ruvector_tpu_torch.graph.csr import CSRGraph


def host_csr(graph: CSRGraph) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(row_ptr, row ids, col_idx, values) of the graph as numpy, read from
    its device in one pass."""
    row_ptr = graph.row_ptr.cpu().numpy()
    rows = np.repeat(np.arange(graph.num_nodes, dtype=np.int32), np.diff(row_ptr))
    return row_ptr, rows, graph.col_idx.cpu().numpy(), graph.values.cpu().numpy()


def conductance(graph: CSRGraph, members: np.ndarray) -> float:
    """cut(S) / min(vol(S), vol(V-S)) on the undirected weighted graph."""
    _, rows, cols, vals = host_csr(graph)
    return _conductance(graph.num_nodes, rows, cols, vals, members)


def _conductance(n: int, rows, cols, vals, members) -> float:
    side = np.zeros(n, bool)
    side[np.asarray(members)] = True
    cut = vals[side[rows] != side[cols]].sum()
    vol_s = vals[side[rows]].sum()
    vol_rest = vals.sum() - vol_s
    denom = min(vol_s, vol_rest)
    return float(cut / denom) if denom > 0 else 1.0


def local_cluster(graph: CSRGraph, seed: int, alpha: float = 0.15,
                  epsilon: float = 1e-5,
                  max_size: int | None = None) -> tuple[np.ndarray, float]:
    """ACL: PPR from the seed, sweep by ppr/degree, return
    (members, conductance) of the best prefix."""
    from ruvector_tpu_torch.solver import forward_push_ppr

    ppr = forward_push_ppr(graph, seed, alpha=alpha, epsilon=epsilon,
                           max_sweeps=300).cpu().numpy()
    row_ptr, rows, cols, vals32 = host_csr(graph)
    deg = np.maximum(np.diff(row_ptr), 1.0)
    score = ppr / deg
    support = np.nonzero(ppr > 0)[0]
    order = support[np.argsort(-score[support])]
    if max_size:
        order = order[:max_size]
    if len(order) == 0:
        return np.asarray([seed]), 1.0

    n = graph.num_nodes
    vals = vals32.astype(np.float64)
    total_vol = vals.sum()
    m = len(order)

    # Vectorized sweep (replaces the per-edge Python loop, which was
    # O(E) per call — untenable at toolkit scale): a CSR copy (r, c)
    # is cut at prefix size k iff r is inside and c outside, i.e. for
    # k in [rank_r+1, min(rank_c, m)]. Accumulate those ranges with a
    # difference array; volumes are a cumsum of row sums over `order`.
    rank = np.full(n, n, np.int64)
    rank[order] = np.arange(m)
    rr, rc = rank[rows], rank[cols]
    act = (rr < m) & (rr < rc)
    lo = rr[act] + 1
    hi = np.minimum(rc[act], m)
    w = vals[act]
    delta = np.zeros(m + 2)
    np.add.at(delta, lo, w)
    np.add.at(delta, hi + 1, -w)
    cut_k = np.cumsum(delta)[1:m + 1]

    rowsum = np.zeros(n)
    np.add.at(rowsum, rows, vals)
    vol_k = np.cumsum(rowsum[order])
    denom = np.minimum(vol_k, total_vol - vol_k)
    phi_k = np.where(denom > 0, cut_k / np.maximum(denom, 1e-300), 1.0)
    best_k = int(np.argmin(phi_k)) + 1
    members = order[:best_k].copy()
    # report with the same convention as conductance() (both CSR copies of
    # each undirected edge counted) so callers can compare directly
    return members, _conductance(n, rows, cols, vals32, members)


@dataclasses.dataclass(frozen=True)
class LocalCut:
    """Result of local_k_cut: a cut of weight `value` (< k) separating
    `members` (which contain the seed) from the rest of the graph."""

    members: np.ndarray          # node ids on the seed side
    value: float                 # total crossing weight
    cut_edges: list              # (u, v) with u inside, v outside
    explored: int                # ball size actually touched


def local_k_cut(graph: CSRGraph, seed: int, k: float,
                max_radius: int = 4,
                max_volume: int = 4096) -> LocalCut | None:
    """Local k-cut (ruvector-mincut/src/localkcut role): find a cut of
    weight < k separating a set containing `seed` from the rest, touching
    only a bounded neighborhood — never the whole graph.

    Method: grow a BFS ball around the seed (bounded by max_radius hops
    and max_volume nodes); contract everything outside the ball into one
    super-sink; exact max-flow (Dinic) seed -> sink inside the ball. If
    the flow is < k the residual's seed-side IS a global cut of that
    weight (every crossing edge is incident to the ball). Returns None
    when no cut below k exists within the explored radius — callers may
    widen the ball or conclude the seed is k-connected locally.
    """
    from ruvector_tpu_torch.attention.mincut import _Dinic

    indptr, _, cols, vals = host_csr(graph)
    vals = vals.astype(np.float64)

    # bounded BFS ball
    ball = {int(seed)}
    frontier = [int(seed)]
    for _ in range(max_radius):
        nxt = []
        for u in frontier:
            for j in range(indptr[u], indptr[u + 1]):
                c = int(cols[j])
                if c not in ball:
                    ball.add(c)
                    nxt.append(c)
            if len(ball) >= max_volume:
                break
        frontier = nxt
        if not frontier or len(ball) >= max_volume:
            break

    nodes = sorted(ball)
    remap = {u: i for i, u in enumerate(nodes)}
    sink = len(nodes)                      # contracted outside super-node
    d = _Dinic(len(nodes) + 1)
    seen_pairs = set()
    for u in nodes:
        iu = remap[u]
        for j in range(indptr[u], indptr[u + 1]):
            c = int(cols[j])
            w = float(vals[j])
            if c in ball:
                key = (min(u, c), max(u, c))
                if key in seen_pairs:
                    continue               # CSR holds both copies
                seen_pairs.add(key)
                d.add_edge(iu, remap[c], w)
                d.add_edge(remap[c], iu, w)
            else:
                d.add_edge(iu, sink, w)    # boundary edge to super-sink
    if sink == 1:
        return None                        # isolated seed: no cut to find
    has_boundary = any(len(d.to[remap[u]]) and sink in d.to[remap[u]]
                       for u in nodes)
    if not has_boundary:
        # ball swallowed the seed's whole component: the local problem IS
        # the component's global min cut (Stoer-Wagner on the ball)
        from ruvector_tpu_torch.mincut.global_dynamic import stoer_wagner

        adj = {}
        for u in nodes:
            for j in range(indptr[u], indptr[u + 1]):
                c = int(cols[j])
                if u < c:
                    adj[(u, c)] = adj.get((u, c), 0.0) + float(vals[j])
        if len(nodes) < 2:
            return None
        val, sset, _ = stoer_wagner(adj, nodes)
        if val >= k:
            return None
        inside = sset if int(seed) in sset else set(nodes) - sset
        cut_edges = [(u, c) for (u, c) in adj if (u in inside) != (c in inside)]
        return LocalCut(members=np.asarray(sorted(inside)),
                        value=float(val),
                        cut_edges=cut_edges, explored=len(nodes))
    flow = d.max_flow(remap[int(seed)], sink)
    if flow >= k:
        return None
    reach = d.reachable(remap[int(seed)])
    members = np.asarray([u for u in nodes if reach[remap[u]]])
    inside = set(int(m) for m in members)
    cut_edges = []
    value = 0.0
    for u in inside:
        for j in range(indptr[u], indptr[u + 1]):
            c = int(cols[j])
            if c not in inside:
                cut_edges.append((u, c))
                value += float(vals[j])
    return LocalCut(members=members, value=value, cut_edges=cut_edges,
                    explored=len(nodes))
