"""Pipeline parallelism: the GPipe microbatch schedule over a ring of
ranks (port of ruvector_tpu/parallel/pp.py).

Consecutive stages live on consecutive ranks and microbatches stream
through the ring: num_microbatches + num_stages - 1 ticks, each rank
applying its stage and shifting its activation to the next rank with one
ring shift per tick. The bubble fraction is (S-1)/(M+S-1). Every stage
runs the same layer function on its own parameters.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.parallel.mesh import Mesh, local_slice
from ruvector_tpu_torch.training.optimizers import tree_leaves, tree_map


def make_pp_forward(layer_fn, mesh: Mesh, num_microbatches: int):
    """Pipeline forward on this rank.

    layer_fn(stage_params, x [B, D]) -> [B, D]: one stage's computation;
    params hold a leading stage axis (one entry a rank; each rank reads
    its own).

    forward(params [S, ...], x [M, B, D]) -> [M, B, D]: microbatch m's
    output equals layer_fn applied S times (stage 0..S-1 in order),
    returned on every rank."""
    n_stage, m = mesh.size, num_microbatches
    stage = mesh.rank

    def forward(params, mb):
        local = tree_map(lambda a: local_slice(a, (mesh.axis_name,), mesh)[0], params)
        buf = torch.zeros_like(mb[0])
        done = [torch.zeros_like(mb[0]) for _ in range(m)]
        for t in range(m + n_stage - 1):
            idx = t - stage                      # the microbatch this stage sees
            if 0 <= idx < m:
                y = layer_fn(local, mb[idx] if stage == 0 else buf)
                if stage == n_stage - 1:         # the last stage banks its output
                    done[idx] = y
            else:
                y = torch.zeros_like(buf)
            buf = mesh.ppermute(y, 1)            # shift around the ring
        # only the last stage holds real outputs; the sum over the ranks
        # (zeros elsewhere) gives them to every rank
        acc = torch.stack(done) if stage == n_stage - 1 else torch.zeros_like(mb)
        return mesh.all_reduce(acc)

    return forward


def params_leading_dim(params) -> int:
    return tree_leaves(params)[0].shape[0]


def reference_pp_forward(layer_fn, params, x_mb):
    """Oracle: every microbatch through all stages in turn."""
    def one(xb):
        for s in range(params_leading_dim(params)):
            xb = layer_fn(tree_map(lambda a: a[s], params), xb)
        return xb

    return torch.stack([one(x_mb[i]) for i in range(x_mb.shape[0])])
