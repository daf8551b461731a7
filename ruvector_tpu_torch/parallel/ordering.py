"""Locality orderings for block execution (port of
ruvector_tpu/parallel/ordering.py). Pure numpy, host side.

`recursive_bisection_order` splits the feature space recursively along
its principal direction, so each block is a compact region of embedding
space; `graph_grow_blocks` grows blocks over the adjacency itself and
needs no features; `halo_fraction` says whether a block layout pays off
(isotropic data has no community structure, and its halos stay ~B).
"""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _top_direction(x: np.ndarray, iters: int = 8, seed: int = 0) -> np.ndarray:
    """Leading principal direction by power iteration on the covariance."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=x.shape[1]).astype(np.float64)
    v /= np.linalg.norm(v) + 1e-30
    xc = x - x.mean(0, keepdims=True)
    for _ in range(iters):
        v = xc.T @ (xc @ v)
        v /= np.linalg.norm(v) + 1e-30
    return v


def recursive_bisection_order(features, leaf_size: int = 1024, seed: int = 0,
                              balance: float = 0.3) -> tuple[np.ndarray, list[int]]:
    """Return (perm, leaf_sizes): perm (new position -> old id) orders
    nodes by recursive splits of the feature space; leaf_sizes are the
    consecutive leaf lengths (<= leaf_size each).

    Each split cuts at the largest projection gap inside the middle
    [balance, 1 - balance] quantile window, not at the exact median, so a
    tight cluster stays whole. Accepts numpy arrays or tensors."""
    f = np.asarray(_host(features), dtype=np.float32)
    n = f.shape[0]
    order = np.empty(n, dtype=np.int64)
    leaf_sizes: list[int] = []
    pos = 0
    stack = [np.arange(n, dtype=np.int64)]
    while stack:
        ids = stack.pop()
        if len(ids) <= leaf_size:
            order[pos: pos + len(ids)] = ids
            leaf_sizes.append(len(ids))
            pos += len(ids)
            continue
        v = _top_direction(f[ids], seed=seed)
        proj = f[ids] @ v.astype(np.float32)
        srt = np.argsort(proj, kind="stable")
        m = len(ids)
        lo = max(1, int(m * balance))
        hi = min(m - 1, int(m * (1.0 - balance)))
        window = proj[srt[lo: hi + 1]]
        gaps = window[1:] - window[:-1]
        cut = lo + 1 + int(np.argmax(gaps)) if len(gaps) else m // 2
        # depth-first, right pushed first so left lands first in `order`
        stack.append(ids[srt[cut:]])
        stack.append(ids[srt[:cut]])
    return order, leaf_sizes


def halo_fraction(nbr_idx, nbr_mask, block: int) -> float:
    """Max over blocks of |unique out-of-block neighbours| / block: the
    block-dense layout is worthwhile when this is small (<~0.5). Accepts
    numpy arrays or tensors."""
    nbr = _host(nbr_idx)
    mask = _host(nbr_mask) > 0
    n = nbr.shape[0]
    worst = 0.0
    for k in range(-(-n // block)):
        rows = slice(k * block, min((k + 1) * block, n))
        flat = nbr[rows][mask[rows]]
        out = flat[(flat < k * block) | (flat >= (k + 1) * block)]
        worst = max(worst, len(np.unique(out)) / block)
    return worst


def graph_grow_blocks(nbr_idx, nbr_mask, leaf_size: int = 1024
                      ) -> tuple[np.ndarray, list[int]]:
    """Graph-grown blocks (METIS-style region growing): BFS-grow a region
    from the lowest unassigned node until `leaf_size`, emit it, repeat;
    then pack consecutive regions into blocks of at most `leaf_size`
    (whole components packed together add no halo).

    Accepts numpy arrays or tensors. Returns (perm, leaf_sizes): perm maps
    new position -> old node id; leaf_sizes are consecutive block lengths.
    """
    nbr = _host(nbr_idx)
    mask = _host(nbr_mask) > 0
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
