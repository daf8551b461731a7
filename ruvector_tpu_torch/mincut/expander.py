"""Expander decomposition: partition into high-conductance clusters
(port of ruvector_tpu/mincut/expander.py).

Reference: ruvector-mincut/src/expander — expander decomposition
underpinning the subpolynomial update structures. Practical variant here:
repeated ACL local clustering (mincut/local.py) from uncovered seeds —
peel off any cluster whose conductance beats phi_target; nodes that no
low-conductance cut separates remain as expander-ish singleton/residual
clusters. Inter-cluster edges are the sparse "boundary" the j-tree
hierarchy would route through; they are exactly what halo planning wants
minimized (parallel/partition.py uses the same objective).
"""

from __future__ import annotations

import numpy as np

from ruvector_tpu_torch.graph.csr import CSRGraph
from ruvector_tpu_torch.mincut.local import host_csr, local_cluster


def expander_decompose(graph: CSRGraph, phi_target: float = 0.1,
                       max_clusters: int = 64,
                       seed_order: np.ndarray | None = None):
    """Returns (labels [n], clusters list, boundary_edge_count).

    Greedy peeling: take the lowest-id uncovered node as seed, carve its
    best local cluster; accept if conductance <= phi_target else make the
    seed a singleton. Repeats until covered.
    """
    n = graph.num_nodes
    labels = np.full(n, -1, np.int64)
    clusters: list[np.ndarray] = []
    order = (np.asarray(seed_order) if seed_order is not None
             else np.arange(n))

    for s in order:
        if labels[s] >= 0 or len(clusters) >= max_clusters:
            continue
        members, phi = local_cluster(graph, int(s))
        members = members[labels[members] < 0]      # only uncovered nodes
        if len(members) == 0 or phi > phi_target:
            members = np.asarray([s])
        cid = len(clusters)
        labels[members] = cid
        clusters.append(members)

    _, rows, cols, vals = host_csr(graph)
    vals = vals.astype(np.float64)

    # Stragglers (max_clusters hit before the peel covered everything):
    # attach each uncovered node to the neighboring cluster it is most
    # strongly connected to (iterated, so chains of uncovered nodes pull
    # in), instead of dumping them all into one meaningless residual
    # blob. Nodes in components with no labeled neighbor at all become
    # per-component clusters (they genuinely are separate pieces).
    if np.any(labels < 0):
        nc = len(clusters)
        for _ in range(64):                      # diameter bound in practice
            unc = labels[rows] < 0
            lab_nbr = unc & (labels[cols] >= 0)
            if not np.any(lab_nbr):
                break
            r, c, w = rows[lab_nbr], cols[lab_nbr], vals[lab_nbr]
            # strongest (node, cluster) attachment via dense accumulate
            key = r * np.int64(nc) + labels[c]
            uniq, inv = np.unique(key, return_inverse=True)
            wsum = np.zeros(len(uniq))
            np.add.at(wsum, inv, w)
            nodes_u = uniq // nc
            cl_u = uniq % nc
            # per-node argmax attachment: sort by (node, weight) and take
            # the last entry per node
            o = np.lexsort((wsum, nodes_u))
            nodes_s, cl_s = nodes_u[o], cl_u[o]
            last = np.nonzero(np.r_[nodes_s[1:] != nodes_s[:-1], True])[0]
            labels[nodes_s[last]] = cl_s[last]
        # truly disconnected leftovers: union-find per component
        rest = np.nonzero(labels < 0)[0]
        if len(rest):
            parent = {int(u): int(u) for u in rest}

            def find(x):
                while parent[x] != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            both = (labels[rows] < 0) & (labels[cols] < 0)
            for r, c in zip(rows[both], cols[both]):
                ra, rb = find(int(r)), find(int(c))
                if ra != rb:
                    parent[ra] = rb
            comp_id: dict[int, int] = {}
            for u in rest:
                root = find(int(u))
                if root not in comp_id:
                    comp_id[root] = len(clusters)
                    clusters.append(np.asarray([], np.int64))
                labels[u] = comp_id[root]
            for root, cid in comp_id.items():
                clusters[cid] = np.nonzero(labels == cid)[0]
        # refresh membership lists for clusters that gained attachments
        for cid in range(nc):
            clusters[cid] = np.nonzero(labels == cid)[0]

    boundary = int((labels[rows] != labels[cols]).sum()) // 2
    return labels, clusters, boundary
