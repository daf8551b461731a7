"""Graph partitioning and the static halo-exchange plans (port of
ruvector_tpu/parallel/partition.py). Host numpy.

Per shard, a contiguous node block plus a static plan of exactly which
local rows each shard sends to every other shard, so that every
neighbour gather becomes local. The plan drives one all-to-all per layer
(`HaloPlan`) or one all-gather of packed boundary rows (`OverlapPlan`).

The orderings and the halo plan take the native runtime's routes where it
builds (`native.available`), as the JAX package does; the Python routes
stay for a tree without it. Every plan array equals the JAX package's bit
for bit on both routes. The Python routes of the remapping loops are
vectorised here; they give the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _graph_arrays(graph):
    return (_host(graph.nbr_idx), _host(graph.nbr_mask).astype(np.float32),
            _host(graph.edge_weight).astype(np.float32))


def bfs_reorder(graph) -> np.ndarray:
    """BFS ordering over the neighbour graph for block locality. Returns
    perm: new position -> old id."""
    from ruvector_tpu_torch import native

    n = graph.num_nodes
    nbr = _host(graph.nbr_idx)
    if native.available:
        return native.bfs_reorder(nbr, _host(graph.nbr_mask))
    mask = _host(graph.nbr_mask) > 0
    visited = np.zeros(n, bool)
    order = []
    for start in range(n):
        if visited[start]:
            continue
        queue = [start]
        visited[start] = True
        while queue:
            u = queue.pop(0)
            order.append(u)
            for v in nbr[u][mask[u]]:
                if not visited[v]:
                    visited[v] = True
                    queue.append(int(v))
    return np.asarray(order, np.int64)


def cluster_reorder(graph, iters: int = 10) -> np.ndarray:
    """Community-clustered ordering by label propagation (keeps each
    community contiguous, minimising the edge cut of a block partition).
    Returns perm: new position -> old id."""
    from ruvector_tpu_torch import native

    nbr = _host(graph.nbr_idx)
    mask = _host(graph.nbr_mask)
    if native.available:
        return native.label_propagation_order(nbr, mask, iters)

    n, _ = nbr.shape
    label = np.arange(n, dtype=np.int64)
    valid = mask > 0
    for _ in range(iters):
        changed = False
        for i in range(n):
            nbrs = nbr[i][valid[i]]
            if len(nbrs) == 0:
                continue
            labels, counts = np.unique(label[nbrs], return_counts=True)
            best = labels[np.lexsort((labels, -counts))][0]
            if best != label[i]:
                label[i] = best
                changed = True
        if not changed:
            break
    return np.argsort(label, kind="stable").astype(np.int64)


def block_partition(n: int, n_shards: int) -> np.ndarray:
    """node -> shard by contiguous equal blocks (after padding)."""
    block = -(-n // n_shards)
    return np.minimum(np.arange(n) // block, n_shards - 1)


def _rank_slices(arrays: dict, rank: int, device) -> dict:
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v[rank])).to(dev)
            for k, v in arrays.items()}


@dataclasses.dataclass
class HaloPlan:
    """Static exchange plan for an edge-partitioned graph.

      n_shards, block (local rows per shard), halo (max rows any pair sends)
      send_idx  [S, S, H] — send_idx[src, dst] = local row ids on `src`
          that `dst` needs (padded with 0)
      send_mask [S, S, H]
      local_nbr_idx  [S, block, M] — neighbour indices in the shard-local
          address space: [0, block) = own rows, [block, block + S*H) = halo
          buffer (src-major), laid out as the all-to-all delivers it
      nbr_mask       [S, block, M]
      edge_weight    [S, block, M]
      node_pad_mask  [S, block] — 1 for real nodes, 0 for padding rows
    """

    n_shards: int
    block: int
    halo: int
    send_idx: np.ndarray
    send_mask: np.ndarray
    local_nbr_idx: np.ndarray
    nbr_mask: np.ndarray
    edge_weight: np.ndarray
    node_pad_mask: np.ndarray

    def host_arrays(self) -> dict:
        return dict(send_idx=self.send_idx, send_mask=self.send_mask,
                    local_nbr_idx=self.local_nbr_idx, nbr_mask=self.nbr_mask,
                    edge_weight=self.edge_weight, node_pad_mask=self.node_pad_mask)

    def device_arrays(self, rank: int, device=None) -> dict:
        """Shard `rank`'s slice of every plan array, as tensors on
        `device` (send_idx [S, H]: what this shard sends to each shard)."""
        return _rank_slices(self.host_arrays(), rank, device)


def _reordered(graph, reorder):
    """(nbr, mask, ew, perm) after the optional locality reordering."""
    nbr, mask, ew = _graph_arrays(graph)
    n = graph.num_nodes
    if not reorder:
        return nbr, mask, ew, np.arange(n, dtype=np.int64)
    perm = cluster_reorder(graph) if reorder == "cluster" else bfs_reorder(graph)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)            # old_id -> new_pos
    return inv[nbr[perm]], mask[perm], ew[perm], perm


def _padded(nbr, mask, ew, n_pad):
    n, m = nbr.shape
    if n_pad > n:
        pad = n_pad - n
        nbr = np.concatenate([nbr, np.zeros((pad, m), nbr.dtype)])
        mask = np.concatenate([mask, np.zeros((pad, m), np.float32)])
        ew = np.concatenate([ew, np.zeros((pad, m), np.float32)])
    return nbr, mask, ew


def build_halo_plan(graph, n_shards: int, reorder: bool | str = False,
                    min_halo: int = 1) -> tuple[HaloPlan, np.ndarray]:
    """Build the halo plan. Returns (plan, perm) where perm maps new
    position -> old node id (identity when reorder=False).

    reorder: False | True/'bfs' (BFS locality order) | 'cluster'
    (label-propagation communities; use this for multi-shard partitions).

    Features must be permuted by `perm` and padded to n_shards*block rows
    (`pad_features_for_plan`)."""
    n = graph.num_nodes
    m = graph.max_degree
    nbr, mask, ew, perm = _reordered(graph, reorder)
    block = -(-n // n_shards)
    n_pad = block * n_shards
    nbr, mask, ew = _padded(nbr, mask, ew, n_pad)
    node_pad_mask = (np.arange(n_pad) < n).astype(np.float32).reshape(n_shards, block)

    from ruvector_tpu_torch import native

    if native.available:
        halo_n, send_idx, send_mask, local_nbr = native.halo_plan(nbr, mask, n_shards, block)
        halo_n = max(halo_n, min_halo)
        if send_idx.shape[-1] < halo_n:  # min_halo padding
            pad = halo_n - send_idx.shape[-1]
            send_idx = np.pad(send_idx, ((0, 0), (0, 0), (0, pad)))
            send_mask = np.pad(send_mask, ((0, 0), (0, 0), (0, pad)))
        return HaloPlan(n_shards=n_shards, block=block, halo=halo_n, send_idx=send_idx,
                        send_mask=send_mask, local_nbr_idx=local_nbr,
                        nbr_mask=mask.reshape(n_shards, block, m),
                        edge_weight=ew.reshape(n_shards, block, m),
                        node_pad_mask=node_pad_mask), perm

    owner = (np.arange(n_pad) // block).astype(np.int32)
    # per (src, dst): sorted unique rows on src needed by dst
    needed = [[np.empty(0, np.int64) for _ in range(n_shards)] for _ in range(n_shards)]
    for dst in range(n_shards):
        rows = slice(dst * block, (dst + 1) * block)
        flat = nbr[rows][mask[rows] > 0]
        if flat.size == 0:
            continue
        owners = owner[flat]
        for src in range(n_shards):
            if src != dst:
                needed[src][dst] = np.unique(flat[owners == src]) - src * block
    halo = max(min_halo, max((len(needed[s][d]) for s in range(n_shards)
                              for d in range(n_shards)), default=min_halo))

    send_idx = np.zeros((n_shards, n_shards, halo), np.int32)
    send_mask = np.zeros((n_shards, n_shards, halo), np.float32)
    # global node id -> position in the dst's [S, H] src-major halo buffer
    halo_pos = np.zeros((n_shards, n_pad), np.int64)
    for src in range(n_shards):
        for dst in range(n_shards):
            loc = needed[src][dst]
            send_idx[src, dst, : len(loc)] = loc
            send_mask[src, dst, : len(loc)] = 1.0
            halo_pos[dst, src * block + loc] = src * halo + np.arange(len(loc))

    local_nbr = np.zeros((n_shards, block, m), np.int32)
    for dst in range(n_shards):
        rows = slice(dst * block, (dst + 1) * block)
        g = nbr[rows].astype(np.int64)
        own = owner[g] == dst
        out = np.where(own, g - dst * block, block + halo_pos[dst, g])
        local_nbr[dst] = np.where(mask[rows] > 0, out, 0)

    return HaloPlan(n_shards=n_shards, block=block, halo=halo, send_idx=send_idx,
                    send_mask=send_mask, local_nbr_idx=local_nbr,
                    nbr_mask=mask.reshape(n_shards, block, m),
                    edge_weight=ew.reshape(n_shards, block, m),
                    node_pad_mask=node_pad_mask), perm


def pad_features_for_plan(features, plan, perm: np.ndarray, device=None) -> torch.Tensor:
    """Permute and pad features to [S*block, D] in the plan's layout, as a
    tensor on `device`."""
    f = _host(features)[perm]
    n_pad = plan.n_shards * plan.block
    if n_pad > f.shape[0]:
        f = np.concatenate([f, np.zeros((n_pad - f.shape[0], f.shape[1]), f.dtype)])
    return torch.from_numpy(np.ascontiguousarray(f)).to(resolve_device(device))


@dataclasses.dataclass
class OverlapPlan:
    """Halo plan v2: packed exchange and an interior/boundary split.

    Each shard all-gathers ONE packed buffer of the boundary rows any
    other shard needs ([S, Bmax], Bmax = most rows a shard publishes), and
    each shard's rows are ordered interior first: rows [0, n_interior) of
    every shard read no halo, so their attention can run while the gather
    is in flight.

      pack_idx   [S, Bmax]  local rows to publish (padded 0)
      pack_mask  [S, Bmax]
      local_nbr  [S, block, M] neighbour addresses: [0, block) = own rows,
                 block + src*Bmax + pos = halo (gathered layout)
      n_interior int — min over shards of the interior row count
    """

    n_shards: int
    block: int
    bmax: int
    n_interior: int
    pack_idx: np.ndarray
    pack_mask: np.ndarray
    local_nbr_idx: np.ndarray
    nbr_mask: np.ndarray
    edge_weight: np.ndarray
    node_pad_mask: np.ndarray

    def host_arrays(self) -> dict:
        return dict(pack_idx=self.pack_idx, pack_mask=self.pack_mask,
                    local_nbr_idx=self.local_nbr_idx, nbr_mask=self.nbr_mask,
                    edge_weight=self.edge_weight, node_pad_mask=self.node_pad_mask)

    def device_arrays(self, rank: int, device=None) -> dict:
        """Shard `rank`'s slice of every plan array, as tensors on `device`."""
        return _rank_slices(self.host_arrays(), rank, device)

    def bytes_per_layer(self, hidden_dim: int, dtype_bytes: int = 4) -> dict:
        """Wire-traffic model for one layer's halo exchange."""
        payload = self.n_shards * self.bmax * hidden_dim * dtype_bytes
        a2a_equiv = self.n_shards * self.n_shards * self.bmax * hidden_dim * dtype_bytes
        return {"all_gather_bytes": payload, "all_to_all_padded_bytes_upper": a2a_equiv,
                "interior_fraction": self.n_interior / self.block}


def build_overlap_plan(graph, n_shards: int,
                       reorder: bool | str = "cluster") -> tuple[OverlapPlan, np.ndarray]:
    """Build the packed, overlapped halo plan. Returns (plan, perm): perm
    maps new padded position -> old node id (-1 for padding rows),
    composed with the interior-first order within each shard."""
    n = graph.num_nodes
    m = graph.max_degree
    nbr, mask, ew = _graph_arrays(graph)
    if reorder:
        perm = cluster_reorder(graph) if reorder == "cluster" else bfs_reorder(graph)
    else:
        perm = np.arange(n, dtype=np.int64)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    nbr, mask, ew = inv[nbr[perm]], mask[perm], ew[perm]

    block = -(-n // n_shards)
    n_pad = block * n_shards
    nbr, mask, ew = _padded(nbr, mask, ew, n_pad)
    real = np.arange(n_pad) < n

    # within-shard interior-first permutation
    owner = (np.arange(n_pad) // block).astype(np.int64)
    row_owner = owner[np.clip(nbr, 0, n_pad - 1)]
    has_remote = ((row_owner != owner[:, None]) & (mask > 0)).any(axis=1)
    perm2 = np.empty(n_pad, np.int64)         # new padded pos -> old padded pos
    interior_counts = []
    for s in range(n_shards):
        rows = np.arange(s * block, (s + 1) * block)
        interior = rows[~has_remote[rows]]
        perm2[s * block: (s + 1) * block] = np.concatenate([interior, rows[has_remote[rows]]])
        interior_counts.append(len(interior))
    n_interior = int(min(interior_counts))

    inv2 = np.empty(n_pad, np.int64)
    inv2[perm2] = np.arange(n_pad)
    nbr = inv2[np.clip(nbr, 0, n_pad - 1)][perm2]
    mask, ew, real = mask[perm2], ew[perm2], real[perm2]

    # new padded position -> old node id (-1 on padding rows)
    composed = np.full(n_pad, -1, np.int64)
    live = perm2 < n
    composed[live] = perm[perm2[live]]

    # packed boundary rows per shard: the union of its rows other shards read
    remote_of = []
    for s in range(n_shards):
        rows = slice(s * block, (s + 1) * block)
        flat = nbr[rows][mask[rows] > 0]
        remote_of.append(flat[(flat < s * block) | (flat >= (s + 1) * block)])
    pack = []
    for s in range(n_shards):
        wanted = np.concatenate([remote_of[d] for d in range(n_shards) if d != s]
                                or [np.empty(0, np.int64)])
        own = wanted[(wanted >= s * block) & (wanted < (s + 1) * block)]
        pack.append(np.unique(own) - s * block)
    bmax = max(1, max(len(p) for p in pack))

    pack_idx = np.zeros((n_shards, bmax), np.int32)
    pack_mask = np.zeros((n_shards, bmax), np.float32)
    halo_pos = np.zeros(n_pad, np.int64)
    for s in range(n_shards):
        pack_idx[s, : len(pack[s])] = pack[s]
        pack_mask[s, : len(pack[s])] = 1.0
        halo_pos[s * block + pack[s]] = s * bmax + np.arange(len(pack[s]))

    local_nbr = np.zeros((n_shards, block, m), np.int32)
    for s in range(n_shards):
        rows = slice(s * block, (s + 1) * block)
        g = nbr[rows]
        own = (g >= s * block) & (g < (s + 1) * block)
        out = np.where(own, g - s * block, block + halo_pos[g])
        local_nbr[s] = np.where(mask[rows] > 0, out, 0)

    plan = OverlapPlan(n_shards=n_shards, block=block, bmax=bmax, n_interior=n_interior,
                       pack_idx=pack_idx, pack_mask=pack_mask, local_nbr_idx=local_nbr,
                       nbr_mask=mask.reshape(n_shards, block, m),
                       edge_weight=ew.reshape(n_shards, block, m),
                       node_pad_mask=real.astype(np.float32).reshape(n_shards, block))
    return plan, composed
