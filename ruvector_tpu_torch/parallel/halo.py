"""Halo exchange and the sharded forward and train step over a 1-D node
mesh (port of ruvector_tpu/parallel/halo.py).

Node features live in contiguous blocks, one a rank. Per layer each rank
W_msg-transforms its own block, exchanges exactly the boundary rows other
ranks need with one all-to-all (driven by the static HaloPlan), and then
the whole neighbour aggregation (gather, attention, weighted mean, GRU,
norm) is rank-local. Messages (hidden_dim) are exchanged, not raw
features.

Each rank calls these functions with its Mesh. A rank's inputs are its
own rows [block, D]; the whole padded array [S*block, D] is accepted too,
and the rank takes its rows from it. Outputs are the rank's rows.

Differentiation runs through the collectives (parallel/mesh.py), so the
same forward powers the sharded train step. The blocked functions run the
same plan in one process, a loop over the blocks in place of the mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.nn.core import gru_apply, layer_norm_apply, linear_apply
from ruvector_tpu_torch.nn.ruvector_layer import _folded_attention_and_aggregate
from ruvector_tpu_torch.parallel.mesh import Mesh
from ruvector_tpu_torch.parallel.partition import HaloPlan
from ruvector_tpu_torch.training.losses import batched_info_nce
from ruvector_tpu_torch.training.optimizers import (apply_updates, requiring_grad, tree_grad,
                                                     tree_map)


def halo_exchange(local_rows: torch.Tensor, send_idx: torch.Tensor, send_mask: torch.Tensor,
                  mesh: Mesh) -> torch.Tensor:
    """Exchange boundary rows: returns the halo buffer [S*H, D] whose slice
    [src*H:(src+1)*H] holds the rows received from rank `src`, matching
    the HaloPlan's src-major halo addressing."""
    outgoing = local_rows[send_idx.long()] * send_mask[..., None]     # [S, H, D]
    return mesh.all_to_all(outgoing).reshape(-1, local_rows.shape[-1])


def _layer_tail(params, cfg, msg, attn_out, weighted, nbr_mask, pad_mask):
    """W_agg, GRU, (1 - dropout), LayerNorm, the isolated-node fallback and
    the padding mask: the rest of a RuvectorLayer after its aggregation."""
    aggregated = linear_apply(params["w_agg"], attn_out + weighted)
    updated = gru_apply(params["gru"], aggregated, msg)
    out = layer_norm_apply(params["norm"], updated * (1.0 - cfg.dropout), cfg.eps)
    isolated = layer_norm_apply(params["norm"], msg, cfg.eps)
    has_nbrs = torch.sum(nbr_mask, dim=1, keepdim=True) > 0
    return torch.where(has_nbrs, out, isolated) * pad_mask[:, None]


def _layer_forward_block(params, cfg, feats_blk, send_idx, send_mask, local_nbr, nbr_mask,
                         edge_weight, pad_mask, mesh: Mesh) -> torch.Tensor:
    """One RuvectorLayer on a rank's block with halo'd neighbour messages:
    the math of nn/ruvector_layer.ruvector_layer_apply."""
    msg = linear_apply(params["w_msg"], feats_blk)                    # [block, Hd]
    halo = halo_exchange(msg, send_idx, send_mask, mesh)              # [S*H, Hd]
    all_msg = torch.cat([msg, halo], dim=0)
    attn_out, weighted = _folded_attention_and_aggregate(
        params["attn"], cfg.heads, msg, all_msg, local_nbr, nbr_mask, edge_weight)
    return _layer_tail(params, cfg, msg, attn_out, weighted, nbr_mask, pad_mask)


def make_sharded_layer_forward(net_cfg, plan: HaloPlan, mesh: Mesh):
    """Multi-layer forward on this rank: (params_list, feats) -> the rank's
    embeddings [block, hidden]."""
    pa = plan.device_arrays(mesh.rank, mesh.device)
    layer_cfgs = net_cfg.layer_cfgs()

    def forward(params_list, feats):
        x = mesh.own_rows(feats, plan.block)
        for params, cfg in zip(params_list, layer_cfgs):
            x = _layer_forward_block(params, cfg, x, pa["send_idx"], pa["send_mask"],
                                     pa["local_nbr_idx"], pa["nbr_mask"], pa["edge_weight"],
                                     pa["node_pad_mask"], mesh)
        return x

    return forward


def global_neighbors(plan: HaloPlan) -> np.ndarray:
    """[S*block, M] neighbour ids in the global padded address space:
    local ids below block are the shard's own rows; halo ids map back to
    their source shard's rows through send_idx."""
    s_n, b, m = plan.local_nbr_idx.shape
    h = plan.halo
    local = plan.local_nbr_idx.astype(np.int64)
    own = local < b
    shard = np.arange(s_n)[:, None, None]
    hp = np.where(own, 0, local - b)
    src, pos = hp // h, hp % h
    remote = plan.send_idx[src, np.broadcast_to(shard, local.shape), pos] + src * b
    return np.where(own, local + shard * b, remote).astype(np.int32).reshape(s_n * b, m)


def _optimizer_step(optimizer, params, grads, opt_state):
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return tree_map(torch.detach, apply_updates(params, updates)), opt_state


def make_sharded_train_step(net_cfg, plan: HaloPlan, mesh: Mesh, optimizer,
                            temperature: float = 0.07):
    """Sharded contrastive train step on this rank.

    step(params, opt_state, feats, neg_ids) -> (params, opt_state, loss)

    Every real node is an anchor with its graph neighbours as positives
    and the given sampled ids (global padded rows, [block, Q] for this
    rank or [S*block, Q]) as negatives. The ranks' outputs are gathered
    for the positives and negatives; each rank takes its anchors' share of
    the global mean, so the loss is the global InfoNCE. The parameter
    gradients are summed over the ranks, then the optimizer steps; every
    rank ends with the same parameters."""
    forward = make_sharded_layer_forward(net_cfg, plan, mesh)
    b = plan.block
    n_pad = plan.n_shards * b
    dev = mesh.device
    rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    nbr = torch.from_numpy(global_neighbors(plan)[rows]).long().to(dev)
    pos_mask = torch.from_numpy(
        plan.nbr_mask[mesh.rank] * plan.node_pad_mask[mesh.rank][:, None]).to(dev)

    def step(params, opt_state, feats, neg_ids):
        req = requiring_grad(params)
        out = forward(req, feats)                                     # [block, Hd]
        table = mesh.all_gather(out)                                  # [N_pad, Hd]
        negs = table[mesh.own_rows(neg_ids, b).long()]
        share = batched_info_nce(out, table[nbr], negs, temperature, pos_mask) * (b / n_pad)
        grads = tree_grad(share, req, reduce=mesh._all_reduce)
        loss = mesh._all_reduce(share.detach().reshape(1))[0]
        params, opt_state = _optimizer_step(optimizer, params, grads, opt_state)
        return params, opt_state, loss

    return step


def make_sharded_mp_forward(step_fns, plan: HaloPlan, mesh: Mesh):
    """Sharded message passing over the halo plan, for GCN, GraphSAGE and
    GAT-style layers.

    step_fns: list of fn(x_blk [B, Din], nbr_feats [B, M, Din], nbr_mask
    [B, M], edge_weight [B, M], pad_mask [B]) -> [B, Dout]. Each layer's
    raw features are halo-exchanged (one all-to-all), then the step runs
    rank-local. Returns forward(feats) -> the rank's rows [block, Dout]."""
    pa = plan.device_arrays(mesh.rank, mesh.device)

    def forward(feats):
        x = mesh.own_rows(feats, plan.block)
        for fn in step_fns:
            halo = halo_exchange(x, pa["send_idx"], pa["send_mask"], mesh)
            nbr_feats = torch.cat([x, halo], dim=0)[pa["local_nbr_idx"].long()]
            x = fn(x, nbr_feats, pa["nbr_mask"], pa["edge_weight"], pa["node_pad_mask"])
        return x

    return forward


def _blocked_tables(plan: HaloPlan, dev):
    """Per block: the global rows of its halo (src-major, as local_nbr_idx
    addresses them) and their mask, and the plan's arrays, on dev."""
    s_n, b, _ = plan.local_nbr_idx.shape
    halo_rows = np.arange(s_n)[:, None, None] * b + plan.send_idx        # [src, dst, H]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(halo_rows=to(np.transpose(halo_rows, (1, 0, 2)).reshape(s_n, -1)).long(),
                halo_mask=to(np.transpose(plan.send_mask, (1, 0, 2)).reshape(s_n, -1)),
                local_nbr=to(plan.local_nbr_idx), nbr_mask=to(plan.nbr_mask),
                edge_weight=to(plan.edge_weight), pad=to(plan.node_pad_mask))


def make_blocked_layer_forward(net_cfg, plan: HaloPlan, device=None):
    """Single-device blocked execution over the same HaloPlan: per block,
    the neighbour gathers read a small local table [block + S*H] (its own
    rows and its halo rows gathered from the whole message table) instead
    of the whole table. The layout is the sharded path's; a loop over the
    blocks replaces the mesh.

    Returns forward(params_list, feats [S*block, Din]) -> [S*block, hidden],
    equal to the sharded forward's rows."""
    dev = resolve_device(device)
    layer_cfgs = net_cfg.layer_cfgs()
    s_n, b, _ = plan.local_nbr_idx.shape
    t = _blocked_tables(plan, dev)

    def forward(params_list, feats):
        x = feats
        for params, cfg in zip(params_list, layer_cfgs):
            msg = linear_apply(params["w_msg"], x)                      # whole table
            blocks = []
            for s in range(s_n):
                own = msg[s * b:(s + 1) * b]
                halo = msg[t["halo_rows"][s]] * t["halo_mask"][s][:, None]
                attn_out, weighted = _folded_attention_and_aggregate(
                    params["attn"], cfg.heads, own, torch.cat([own, halo], dim=0),
                    t["local_nbr"][s], t["nbr_mask"][s], t["edge_weight"][s])
                blocks.append(_layer_tail(params, cfg, own, attn_out, weighted,
                                          t["nbr_mask"][s], t["pad"][s]))
            x = torch.cat(blocks, dim=0)
        return x

    return forward


def make_blocked_train_step(net_cfg, plan: HaloPlan, optimizer, temperature: float = 0.07,
                            device=None):
    """Single-device training with the blocked forward: the objective of
    make_sharded_train_step, with the gradient through the block loop in
    place of the collectives."""
    dev = resolve_device(device)
    forward = make_blocked_layer_forward(net_cfg, plan, dev)
    nbr = torch.from_numpy(global_neighbors(plan)).long().to(dev)
    s_n, b, m = plan.local_nbr_idx.shape
    pos_mask = torch.from_numpy(
        (plan.nbr_mask * plan.node_pad_mask[..., None]).reshape(s_n * b, m)).to(dev)

    def step(params, opt_state, feats, neg_ids):
        req = requiring_grad(params)
        out = forward(req, feats)
        loss = batched_info_nce(out, out[nbr], out[neg_ids.long()], temperature, pos_mask)
        grads = tree_grad(loss, req)
        params, opt_state = _optimizer_step(optimizer, params, grads, opt_state)
        return params, opt_state, loss.detach()

    return step


# ---------------------------------------------------------------------------
# Overlapped halo exchange: one all-gather of the packed boundary rows; the
# interior rows' attention needs no halo and is issued first.
# ---------------------------------------------------------------------------

def _layer_forward_overlap(params, cfg, feats_blk, pack_idx, pack_mask, local_nbr, nbr_mask,
                           edge_weight, pad_mask, n_interior: int, mesh: Mesh):
    msg = linear_apply(params["w_msg"], feats_blk)                    # [block, Hd]
    pack = msg[pack_idx.long()] * pack_mask[:, None]                  # [Bmax, Hd]
    halo = mesh.all_gather(pack)                                      # [S*Bmax, Hd]
    ni = n_interior
    # interior rows: no dependence on the halo
    attn_i, wmean_i = _folded_attention_and_aggregate(
        params["attn"], cfg.heads, msg[:ni], msg, local_nbr[:ni], nbr_mask[:ni],
        edge_weight[:ni])
    attn_b, wmean_b = _folded_attention_and_aggregate(
        params["attn"], cfg.heads, msg[ni:], torch.cat([msg, halo], dim=0), local_nbr[ni:],
        nbr_mask[ni:], edge_weight[ni:])
    return _layer_tail(params, cfg, msg, torch.cat([attn_i, attn_b], dim=0),
                       torch.cat([wmean_i, wmean_b], dim=0), nbr_mask, pad_mask)


def make_overlap_layer_forward(net_cfg, plan, mesh: Mesh):
    """Multi-layer forward on this rank over the OverlapPlan: the packed
    all-gather halo and the interior/boundary split per layer. Returns
    forward(params_list, feats) -> the rank's rows [block, hidden]."""
    pa = plan.device_arrays(mesh.rank, mesh.device)
    layer_cfgs = net_cfg.layer_cfgs()

    def forward(params_list, feats):
        x = mesh.own_rows(feats, plan.block)
        for params, cfg in zip(params_list, layer_cfgs):
            x = _layer_forward_overlap(params, cfg, x, pa["pack_idx"], pa["pack_mask"],
                                       pa["local_nbr_idx"], pa["nbr_mask"], pa["edge_weight"],
                                       pa["node_pad_mask"], plan.n_interior, mesh)
        return x

    return forward
