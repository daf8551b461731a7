"""The min-cut-gated graph transformer (config 5) sharded over its
partitions: each rank holds a contiguous run of the block-dense blocks.

The JAX package has no module for this: its multichip dry run
(`__graft_entry__.py:124-190`) shards the block axis with NamedSharding
and lets jit partition the program. Here each rank runs the port's
functions on its own blocks and the ranks meet only where the model is
global:

- the loss: each rank's sum of squared error and its count of real rows
  are summed over the ranks; the gradient is each rank's local backward
  of its error over the global count, summed over the ranks;
- the step's re-solve budget: taken over the global block count, and the
  blocks to re-solve chosen by the global top-k of the drift score (every
  rank gathers all scores and selects the same blocks under the
  lower-index-first rule); each rank then re-solves the chosen blocks it
  owns. A per-rank budget would be another result.

Everything else (signatures, gates, layers) is per block, so a rank's
blocks get the bits the one-process model gives them. The layout must
keep each block's table inside the rank's blocks (config 5's layout is
halo-free: table == block).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ruvector_tpu_torch.graph.block_dense import BlockDenseGraph
from ruvector_tpu_torch.graph_transformer import gated
from ruvector_tpu_torch.parallel.mesh import Mesh, own_rows
from ruvector_tpu_torch.training.optimizers import requiring_grad, tree_grad


def block_ranges(n_blocks: int, size: int) -> list[tuple[int, int]]:
    """Contiguous block runs, one a rank; the first n_blocks % size ranks
    hold one block more (3906 over 4: 977, 977, 976, 976)."""
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(n_blocks), size)])
    return [(int(bounds[r]), int(bounds[r + 1])) for r in range(size)]


@dataclasses.dataclass
class GatedShard:
    """A rank's share of a block-dense layout: blocks [start, stop) of
    nb_total, with table indices in the rank's own rows."""

    mesh: Mesh
    bdg: BlockDenseGraph
    start: int
    stop: int
    nb_total: int

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows of x: x itself when it holds the rank's rows,
        its slice when it holds the whole padded [nB_total*B, ...] array."""
        b = self.bdg.block
        return own_rows(x, self.start * b, self.stop * b, self.nb_total * b)


def slice_block_dense(bdg: BlockDenseGraph, start: int, stop: int) -> BlockDenseGraph:
    """Blocks [start, stop) of a layout as a layout of their own: every
    table index that addresses a global row is moved into the slice's
    rows. Raises ValueError where a block reads a row outside the slice."""
    b = bdg.block
    n_loc = (stop - start) * b
    lid = bdg.local_ids[start:stop].long() - start * b
    wd = bdg.wdense[start:stop]
    outside = (lid < 0) | (lid >= n_loc)
    if bool((outside & (wd != 0).any(dim=1)).any()):
        raise ValueError(f"blocks [{start}, {stop}) read rows of other blocks: a rank's "
                         "tables must stay in its blocks (a halo-free layout)")
    pos = bdg.node_pos
    keep = (pos >= start * b) & (pos < stop * b)
    return BlockDenseGraph(
        local_ids=torch.where(outside, torch.zeros_like(lid), lid).to(bdg.local_ids.dtype),
        wdense=wd, degrees=bdg.degrees[start:stop], node_pad=bdg.node_pad[start:stop],
        node_pos=pos[keep] - start * b, n=int(bdg.node_pad[start:stop].sum()),
        log_mult=None if bdg.log_mult is None else bdg.log_mult[start:stop])


def shard_block_dense(bdg: BlockDenseGraph, mesh: Mesh) -> GatedShard:
    """This rank's share of a whole layout."""
    start, stop = block_ranges(bdg.n_blocks, mesh.size)[mesh.rank]
    return GatedShard(mesh, slice_block_dense(bdg, start, stop), start, stop, bdg.n_blocks)


class _GlobalBudget:
    """The step's re-solve selection over every rank's blocks: the ranks
    gather the flags and scores (padded to the longest run; a padding
    entry is never flagged) and all select the same blocks."""

    def __init__(self, shard: GatedShard):
        self.mesh = shard.mesh
        self.width = max(stop - start for start, stop in
                         block_ranges(shard.nb_total, shard.mesh.size))

    def _gather(self, t: torch.Tensor, fill) -> torch.Tensor:
        padded = torch.full((self.width,), fill, dtype=t.dtype, device=t.device)
        padded[:t.shape[0]] = t
        return self.mesh._all_gather(padded)

    def any(self, mask: torch.Tensor) -> bool:
        return bool(self.mesh._all_reduce(mask.any().to(torch.int32).reshape(1))[0] > 0)

    def top(self, score: torch.Tensor, flagged: torch.Tensor, budget: int):
        """(this rank's local indices of the chosen blocks, the global
        number chosen)."""
        idx, n = gated._LocalBudget.top(self._gather(score, -1.0),
                                        self._gather(flagged.to(torch.int32), 0) > 0, budget)
        mine = idx[torch.div(idx, self.width, rounding_mode="floor") == self.mesh.rank]
        return mine % self.width, n


def sharded_gate_state_init(params, cfg, fpad, shard: GatedShard) -> dict:
    """gate_state_init on the rank's blocks (fpad: its rows or the whole
    padded array). Returns the rank's share of the state."""
    x = shard.own(fpad)
    return gated._gate_state_init(params, cfg, x, shard.bdg, shard.nb_total, shard.start)


def sharded_step(params, cfg, fpad, shard: GatedShard, state: dict,
                 max_resolve: int | None = None):
    """gated_graph_transformer_step on the rank's blocks under the global
    budget (max(1, int(nB_total * max_resolve_frac)) unless given) and
    the global choice of blocks. Returns (the rank's rows of the output,
    its share of the new state, the global number re-solved)."""
    return gated._step(params, cfg, shard.own(fpad), shard.bdg, state, max_resolve,
                       shard.nb_total, _GlobalBudget(shard))


def sharded_value_and_grad(params, cfg, fpad, shard: GatedShard, targets,
                           keep_masks=None):
    """The global mean-squared loss and its gradient, the same on every
    rank: the stateless forward (gates solved in the call) or, with the
    rank's share of the state's keep masks, the forward under them.
    Returns (loss, gradient tree)."""
    mesh = shard.mesh
    x, tgt = shard.own(fpad), shard.own(targets)
    req = requiring_grad(params)
    if keep_masks is None:
        out = gated.gated_graph_transformer_apply(req, cfg, x, shard.bdg)
    else:
        out = gated.gated_graph_transformer_apply_with_masks(req, cfg, x, shard.bdg, keep_masks)
    pad = shard.bdg.node_pad.reshape(-1, 1)
    err = (out - tgt) * pad
    sse = torch.sum(err * err)
    sums = mesh._all_reduce(torch.stack([sse.detach(), torch.sum(pad)]))
    count = torch.clamp(sums[1], min=1.0)
    grads = tree_grad(sse / count, req, reduce=mesh._all_reduce)
    return sums[0] / count, grads
