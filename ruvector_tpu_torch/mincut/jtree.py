"""J-tree-style hierarchical cut oracle (port of
ruvector_tpu/mincut/jtree.py).

Reference: ruvector-mincut/src/jtree — cut/flow hierarchy over expander
clusters answering approximate min-cut queries without a full max-flow
per query. Here: expander decomposition (mincut/expander.py) builds the
cluster level; clusters collapse into super-nodes whose pairwise weights
are the inter-cluster cut; recursion until one cluster remains. An s-t
query walks both leaf-to-root paths and returns the minimum cluster
boundary separating the two — an upper bound on (and at gate scale a
good proxy for) the true min-cut, O(depth) per query after setup.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ruvector_tpu_torch.graph.csr import CSRGraph
from ruvector_tpu_torch.mincut.expander import expander_decompose
from ruvector_tpu_torch.mincut.local import host_csr


@dataclasses.dataclass
class _Level:
    labels: np.ndarray          # node -> cluster at this level
    boundary_weight: np.ndarray  # cluster -> total weight leaving it


class JTree:
    def __init__(self, graph: CSRGraph, phi_target: float = 0.2,
                 max_levels: int = 8):
        self.levels: list[_Level] = []
        _, src, dst, w = host_csr(graph)
        w = w.astype(np.float64)
        n = graph.num_nodes
        dev = graph.row_ptr.device

        for _ in range(max_levels):
            g = CSRGraph.from_edges(src, dst, w.astype(np.float32), n, device=dev)
            labels, clusters, _ = expander_decompose(g, phi_target)
            nc = len(clusters)
            boundary = np.zeros(nc)
            cross = labels[src] != labels[dst]
            np.add.at(boundary, labels[src[cross]], w[cross])
            self.levels.append(_Level(labels=labels,
                                      boundary_weight=boundary))
            if nc <= 1:
                break
            # collapse: cluster graph for the next level
            cs, cd, cw = labels[src[cross]], labels[dst[cross]], w[cross]
            key = cs * nc + cd
            order = np.argsort(key)
            key, cs, cd, cw = key[order], cs[order], cd[order], cw[order]
            uniq, start = np.unique(key, return_index=True)
            sums = np.add.reduceat(cw, start) if len(cw) else cw
            src, dst, w, n = uniq // nc, uniq % nc, sums, nc
            if len(src) == 0:
                break

    def _path(self, node: int) -> list[tuple[int, float]]:
        """Leaf-to-root list of (cluster id, boundary weight)."""
        out = []
        cur = node
        for lv in self.levels:
            cur = int(lv.labels[cur])
            out.append((cur, float(lv.boundary_weight[cur])))
        return out

    def query_cut_upper_bound(self, s: int, t: int) -> float:
        """Min boundary among clusters containing exactly one of s, t —
        every such boundary is a valid s-t separator, so the result is
        always >= the true s-t min cut. Returns inf when s and t share a
        cluster at every level (the hierarchy has no separator to offer
        — callers must fall back to an exact solve, not treat it as 0)."""
        ps, pt = self._path(s), self._path(t)
        best = np.inf
        for (cs, ws), (ct, wt) in zip(ps, pt):
            if cs == ct:
                break                      # merged: higher levels merge too
            best = min(best, ws, wt)
        return float(best)

    def same_cluster_level(self, s: int, t: int) -> int:
        """First level at which s and t merge (depth proxy for closeness)."""
        for i, ((cs, _), (ct, _)) in enumerate(zip(self._path(s),
                                                   self._path(t))):
            if cs == ct:
                return i
        return len(self.levels)
