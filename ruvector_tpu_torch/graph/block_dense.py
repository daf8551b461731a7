"""Block-dense graph layout: neighbor aggregation as dense block products
(port of ruvector_tpu/graph/block_dense.py).

Nodes are blocked contiguously (after a locality ordering such as
parallel/ordering.graph_grow_blocks). For each block the union of its own
rows and its out-of-block neighbors (the halo) forms a local table of
T = block + halo_max rows, rounded up to `table_pad`. Every neighbor
relation then lives inside a dense [B, T] tile, so scores and
aggregation are dense products against the block's local table.

Two routes build the same tables, bit for bit, as in the JAX package.
For uniform blocks where the native runtime is built, the device fill
plans the local tables on the host (native.bdense_plan) and scatters the
normalized per-edge weights into the [nB, B, T] table on the device, so
only ~N*M values cross to it. It falls back to the Python route when a
node lists a neighbor in several slots, which is also the route for
`leaf_sizes` blocks. The JAX package's third route, the threaded native
host fill, stays available as native.bdense_build but builds no layout
here: it sums a row's weights in another order, so its table differs
from these in the last bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device

_EPS_EDGE = 1e-7  # marks real zero-weight edges in wdense


@dataclasses.dataclass(frozen=True)
class BlockDenseGraph:
    """Static block-local dense adjacency.

    local_ids: [nB, T] int32 — padded row of each local-table column: the
        block's own rows at [0, len), its halo at [B, B + len(halo)),
        zero-padded.
    wdense:    [nB, B, T] — normalized edge weight from block row r to
        local column t; 0 = no edge, 1e-7 = a real zero-weight edge.
    degrees:   [nB, B] float32 — true degree per node.
    node_pad:  [nB, B] float32 — 1 for real nodes, 0 for padding.
    node_pos:  [N] int64 — padded row of original node i.
    n:         true node count.
    log_mult:  [nB, B, T] float32 log edge multiplicity, present only when
        some node lists the same neighbor in several slots.
    """

    local_ids: torch.Tensor
    wdense: torch.Tensor
    degrees: torch.Tensor
    node_pad: torch.Tensor
    node_pos: torch.Tensor
    n: int
    log_mult: torch.Tensor | None = None

    @property
    def n_blocks(self) -> int:
        return self.local_ids.shape[0]

    @property
    def block(self) -> int:
        return self.wdense.shape[1]

    @property
    def table(self) -> int:
        return self.local_ids.shape[1]

    def wdense_as(self, dtype: torch.dtype) -> torch.Tensor:
        """wdense in `dtype`, cast once and kept with the graph (the gated
        layer kernels read a bf16 edge table in bf16 compute mode)."""
        if self.wdense.dtype == dtype:
            return self.wdense
        casts = self.__dict__.setdefault("_wdense_casts", {})
        if dtype not in casts:
            casts[dtype] = self.wdense.to(dtype)
        return casts[dtype]

    def pad_features(self, features: torch.Tensor) -> torch.Tensor:
        """Scatter [N, D] node features into the padded [nB*B, D] layout."""
        f = torch.as_tensor(features).to(self.wdense.device)
        out = torch.zeros((self.n_blocks * self.block, f.shape[1]),
                          dtype=f.dtype, device=f.device)
        out[self.node_pos] = f[: self.n]
        return out

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        """Gather padded [nB*B, ...] rows back to original order [N, ...]."""
        return x[self.node_pos]


def _numpy(a, dtype=None):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a) if dtype is None else np.asarray(a).astype(dtype)


def _normalized_weights(ew: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Row-normalized edge weights with the uniform fallback
    (layer.rs:428-432); real edges floored at _EPS_EDGE so that the mask
    `wdense > 0` keeps them."""
    w = ew * mask
    wsum = w.sum(1, keepdims=True)
    deg = np.maximum(mask.sum(1, keepdims=True), 1.0)
    wnorm = np.where(wsum > 0, w / np.where(wsum > 0, wsum, 1.0), mask / deg)
    return np.where(mask > 0, np.maximum(wnorm, _EPS_EDGE), 0.0)


def _densify_device(slot: np.ndarray, wnorm: torch.Tensor, nb: int, block: int, t: int,
                    dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """Scatter per-edge weights into the padded [nb, block, t] table on the
    device. slot: [n, m] local-table columns, t for a masked edge (dropped).
    Chunked over block-aligned row ranges so that a chunk's flat index
    stays below 2**31."""
    n = slot.shape[0]
    rows_total = nb * block
    max_rows = max(((2**31 - 1) // t) // block * block, block)
    table = torch.zeros((nb, block, t), dtype=dtype, device=dev)
    for lo in range(0, min(rows_total, n), max_rows):
        hi = min(n, lo + max_rows)
        s = torch.from_numpy(slot[lo:hi]).to(dev).long()
        keep = s < t
        flat = torch.arange(hi - lo, device=dev)[:, None] * t + s
        table.view(-1)[lo * t: lo * t + (hi - lo) * t][flat[keep]] = wnorm[lo:hi][keep]
    return table


def _device_fill(nbr, mask, ew, n, block, table_pad, dtype, dev):
    """The device-fill route: a BlockDenseGraph, or None where a node lists
    a neighbor in several slots."""
    from ruvector_tpu_torch import native

    lid, slot, dup = native.bdense_plan(nbr, mask, block=block, table_pad=table_pad)
    if dup:
        return None
    nb, t = lid.shape
    wnorm = torch.from_numpy(_normalized_weights(ew, mask)).to(dev).to(dtype)
    degrees = np.zeros((nb, block), np.float32)
    degrees.reshape(-1)[:n] = mask.sum(1)
    node_pad = np.zeros((nb, block), np.float32)
    node_pad.reshape(-1)[:n] = 1.0
    return BlockDenseGraph(
        local_ids=torch.from_numpy(lid).to(dev),
        wdense=_densify_device(slot, wnorm, nb, block, t, dtype, dev),
        degrees=torch.from_numpy(degrees).to(dev),
        node_pad=torch.from_numpy(node_pad).to(dev),
        node_pos=torch.arange(n, dtype=torch.int64, device=dev),
        n=n)


def build_block_dense(nbr_idx, nbr_mask, edge_weight, block: int = 1024,
                      table_pad: int = 128, dtype=torch.float32,
                      leaf_sizes: list[int] | None = None,
                      device_fill: bool | None = None,
                      device=None) -> BlockDenseGraph:
    """Build from padded-slot adjacency (numpy arrays or tensors), already
    locality-ordered. `leaf_sizes`: consecutive leaf lengths — each leaf
    becomes one block padded to the largest leaf rounded up to 8; without
    it nodes are cut into uniform `block`-sized chunks. `dtype` is the
    torch dtype of `wdense` (float32 or bfloat16). `device_fill` keeps
    the JAX package's signature; either value builds by the device fill
    (see the module's docstring)."""
    from ruvector_tpu_torch import native

    dev = resolve_device(device)
    nbr = _numpy(nbr_idx)
    mask = _numpy(nbr_mask, np.float32)
    ew = _numpy(edge_weight, np.float32)
    n = nbr.shape[0]
    if leaf_sizes is None and native.available:
        graph = _device_fill(nbr, mask, ew, n, block, table_pad, dtype, dev)
        if graph is not None:
            return graph

    if leaf_sizes is None:
        nb = -(-n // block)
        starts = [min(k * block, n) for k in range(nb)]
        lens = [min(n - s, block) for s in starts]
        bsz = block
    else:
        if sum(leaf_sizes) != n:
            raise ValueError("leaf_sizes must cover all nodes")
        nb = len(leaf_sizes)
        starts = list(np.cumsum([0] + list(leaf_sizes[:-1])))
        lens = list(leaf_sizes)
        bsz = max(8, -(-max(lens) // 8) * 8)

    node_pos = np.zeros(n, np.int64)
    for k in range(nb):
        node_pos[starts[k]: starts[k] + lens[k]] = k * bsz + np.arange(lens[k])

    wnorm = _normalized_weights(ew, mask)

    # per block: halo = sorted unique out-of-block neighbors
    halos = []
    for k in range(nb):
        rows = slice(starts[k], starts[k] + lens[k])
        flat = nbr[rows][mask[rows] > 0]
        out = flat[(flat < starts[k]) | (flat >= starts[k] + lens[k])]
        halos.append(np.unique(out))
    halo_max = max((len(h) for h in halos), default=0)
    table = -(-(bsz + halo_max) // table_pad) * table_pad

    local_ids = np.zeros((nb, table), np.int32)
    wdense = np.zeros((nb, bsz, table), np.float32)
    counts = np.zeros((nb, bsz, table), np.float32)
    pos = np.full(n, -1, np.int64)     # global -> local column, reset per block
    for k in range(nb):
        own = np.arange(starts[k], starts[k] + lens[k], dtype=np.int64)
        h = halos[k]
        # own rows at [0, lens), halo always at [bsz, bsz + len(h)) — also
        # for a short tail block: the fused layer builds its local table
        # as concat(own block rows, halo rows)
        local_ids[k, : lens[k]] = node_pos[own]
        local_ids[k, bsz: bsz + len(h)] = node_pos[h]
        pos[own] = np.arange(lens[k])
        pos[h] = bsz + np.arange(len(h))
        rows = slice(starts[k], starts[k] + lens[k])
        r, s = np.nonzero(mask[rows] > 0)
        cols = pos[nbr[rows][r, s]]
        # duplicate neighbor slots accumulate (kNN graphs have none)
        np.add.at(wdense[k], (r, cols), wnorm[rows][r, s])
        np.add.at(counts[k], (r, cols), 1.0)
        pos[own] = -1
        pos[h] = -1

    degrees = np.zeros((nb, bsz), np.float32)
    node_pad = np.zeros((nb, bsz), np.float32)
    degs = mask.sum(1)
    for k in range(nb):
        degrees[k, : lens[k]] = degs[starts[k]: starts[k] + lens[k]]
        node_pad[k, : lens[k]] = 1.0
    log_mult = None
    if counts.size and counts.max() > 1.0:
        log_mult = torch.from_numpy(np.log(np.maximum(counts, 1.0))).to(dev)
    return BlockDenseGraph(
        local_ids=torch.from_numpy(local_ids).to(dev),
        wdense=torch.from_numpy(wdense).to(dev).to(dtype),
        degrees=torch.from_numpy(degrees).to(dev),
        node_pad=torch.from_numpy(node_pad).to(dev),
        node_pos=torch.from_numpy(node_pos).to(dev),
        n=n,
        log_mult=log_mult,
    )
