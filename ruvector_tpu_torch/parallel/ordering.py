"""Locality ordering for block execution (port of
ruvector_tpu/parallel/ordering.py:107-171). Pure numpy, host side.
"""

from __future__ import annotations

import numpy as np


def graph_grow_blocks(nbr_idx, nbr_mask, leaf_size: int = 1024
                      ) -> tuple[np.ndarray, list[int]]:
    """Graph-grown blocks (METIS-style region growing): BFS-grow a region
    from the lowest unassigned node until `leaf_size`, emit it, repeat;
    then pack consecutive regions into blocks of at most `leaf_size`
    (whole components packed together add no halo).

    Accepts numpy arrays or tensors. Returns (perm, leaf_sizes): perm maps
    new position -> old node id; leaf_sizes are consecutive block lengths.
    """
    nbr = np.asarray(nbr_idx.cpu() if hasattr(nbr_idx, "cpu") else nbr_idx)
    mask = np.asarray(nbr_mask.cpu() if hasattr(nbr_mask, "cpu") else nbr_mask) > 0
    n = nbr.shape[0]

    # symmetrized CSR adjacency: growth over out-edges alone fragments
    # the communities of a kNN digraph
    src = np.repeat(np.arange(n), nbr.shape[1])[mask.reshape(-1)]
    dst = nbr.reshape(-1)[mask.reshape(-1)]
    us = np.concatenate([src, dst])
    vs = np.concatenate([dst, src])
    order_e = np.argsort(us, kind="stable")
    us, vs = us[order_e], vs[order_e]
    row_ptr = np.searchsorted(us, np.arange(n + 1))

    assigned = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    region_sizes: list[int] = []
    pos = 0
    seed_cursor = 0
    while pos < n:
        while seed_cursor < n and assigned[seed_cursor]:
            seed_cursor += 1
        if seed_cursor >= n:
            break
        block_nodes = [seed_cursor]
        assigned[seed_cursor] = True
        frontier = [seed_cursor]
        while frontier and len(block_nodes) < leaf_size:
            nxt: list[int] = []
            for u in frontier:
                for v in vs[row_ptr[u]: row_ptr[u + 1]]:
                    v = int(v)
                    if not assigned[v] and len(block_nodes) < leaf_size:
                        assigned[v] = True
                        block_nodes.append(v)
                        nxt.append(v)
            frontier = nxt
        order[pos: pos + len(block_nodes)] = block_nodes
        region_sizes.append(len(block_nodes))
        pos += len(block_nodes)

    leaf_sizes: list[int] = []
    acc = 0
    for s in region_sizes:
        if acc and acc + s > leaf_size:
            leaf_sizes.append(acc)
            acc = 0
        acc += s
    if acc:
        leaf_sizes.append(acc)
    return order, leaf_sizes
