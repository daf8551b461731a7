"""Rank functions of the port's parallel tests, run by
`ruvector_tpu_torch.parallel.run_ranks` in spawned processes.

A spawned rank imports this module to find its function, so it imports
torch, numpy and the port only: never jax, nor the JAX package (the
tests hold the ranks to that). Inputs cross as numpy arrays; JAX
parameters as numpy pytrees.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.graph import build_block_dense
from ruvector_tpu_torch.graph_transformer import gated
from ruvector_tpu_torch.parallel import (
    make_ep_forward,
    make_overlap_layer_forward,
    make_pp_forward,
    make_ring_attention,
    make_sharded_layer_forward,
    make_sharded_mp_forward,
    make_sharded_train_step,
    make_tp_layer_forward,
    shard_block_dense,
    sharded_gate_state_init,
    sharded_step,
    sharded_value_and_grad,
)
from ruvector_tpu_torch.serve.distributed import make_distributed_search
from ruvector_tpu_torch.training.optimizers import adam


def jax_modules() -> list[str]:
    """Modules of jax, jaxlib or the JAX package loaded in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ruvector_tpu"))


def modules_rank(mesh) -> list[str]:
    return jax_modules()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gcn_step(params, normalize, use_bias):
    """tests/test_parallel.py's block-local GCN step."""
    def step(x, nbr_feats, nbr_mask, edge_weight, pad_mask):
        w = nbr_mask * edge_weight
        agg = torch.sum(w[..., None] * nbr_feats, dim=1)
        if normalize:
            deg = torch.clamp(torch.sum(nbr_mask, dim=1, keepdim=True), min=1.0)
            agg = agg / torch.sqrt(deg)
        out = agg @ params["kernel"]
        if use_bias:
            out = out + params["bias"]
        return torch.relu(out) * pad_mask[:, None]
    return step


def _tanh_layer(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def halo_cases(mesh, c: dict) -> dict:
    """Forward, train steps, GCN and overlap forward on the halo plans."""
    params = params_from_numpy(c["params"], "cpu")
    out = {"forward": make_sharded_layer_forward(c["cfg"], c["plan"], mesh)(
        params, _t(c["feats_pad"]))}
    if "steps" in c:
        step = make_sharded_train_step(c["cfg"], c["plan"], mesh, adam(c["lr"]), 0.07)
        opt = adam(c["lr"])
        p, state, losses = params, opt.init(params), []
        for _ in range(c["steps"]):
            p, state, loss = step(p, state, _t(c["feats_pad"]), _t(c["neg_ids"]))
            losses.append(float(loss))
        out["losses"], out["trained"] = losses, p
    if "gcn" in c:
        fns = [_gcn_step(params_from_numpy(gp, "cpu"), *flags) for gp, flags in c["gcn"]]
        out["gcn"] = make_sharded_mp_forward(fns, c["plan"], mesh)(_t(c["feats_pad"]))
    if "overlap" in c:
        ov = c["overlap"]
        out["overlap"] = make_overlap_layer_forward(c["cfg"], ov["plan"], mesh)(
            params_from_numpy(ov["params"], "cpu"), _t(ov["feats_pad"]))
    return out


def transformer_cases(mesh, c: dict) -> dict:
    """TP (forward and gradient), EP, PP and ring attention."""
    out = {}
    tp = c["tp"]
    tparams = params_from_numpy(tp["params"], "cpu")
    fwd = make_tp_layer_forward(tp["cfg"], mesh)
    out["tp"] = fwd(tparams, _t(tp["x"]))
    gp = params_from_numpy(c["tp_grad"]["params"], "cpu")
    wq = gp["wq"].requires_grad_(True)
    gfwd = make_tp_layer_forward(c["tp_grad"]["cfg"], mesh)
    loss = torch.sum(gfwd(dict(gp, wq=wq), _t(c["tp_grad"]["x"])) ** 2)
    out["tp_grad_wq"] = torch.autograd.grad(loss, wq)[0]
    ep = c["ep"]
    out["ep"] = make_ep_forward(ep["cfg"], mesh)(params_from_numpy(ep["params"], "cpu"),
                                                 _t(ep["x"]))
    pp = c["pp"]
    out["pp"] = make_pp_forward(_tanh_layer, mesh, pp["m"])(
        params_from_numpy(pp["params"], "cpu"), _t(pp["x"]))
    q, k, v = (_t(a) for a in c["sp"]["qkv"])
    s = q.shape[0]
    out["sp"] = {causal: make_ring_attention(mesh, s, causal=causal)(q, k, v)
                 for causal in (True, False)}
    return out


def gated_cases(mesh, c: dict) -> dict:
    """The sharded gated graph transformer: stateless value and gradient,
    gate state, drifted steps under the global budget, masked gradient."""
    bdg = build_block_dense(c["idx"], c["mask"], c["ew"], block=c["block"],
                            table_pad=c["table_pad"], device="cpu")
    shard = shard_block_dense(bdg, mesh)
    cfg = c["cfg"]
    params = params_from_numpy(c["params"], "cpu")
    fpad = bdg.pad_features(_t(c["feats"]))
    zeros = torch.zeros_like(fpad)
    out = {"range": (shard.start, shard.stop)}
    out["loss"], out["grads"] = sharded_value_and_grad(params, cfg, fpad, shard, zeros)
    state = sharded_gate_state_init(params, cfg, fpad, shard)
    out["init"] = state
    steps = []
    for feats, max_resolve in c["steps"]:
        y, state, nres = sharded_step(params, cfg, bdg.pad_features(_t(feats)), shard, state,
                                      max_resolve=max_resolve)
        steps.append((y, state, nres))
    out["steps"] = steps
    out["masked_loss"], out["masked_grads"] = sharded_value_and_grad(
        params, cfg, fpad, shard, zeros, keep_masks=state["keep"])
    return out


def search_case(mesh, c: dict) -> tuple:
    search = make_distributed_search(mesh, c["n"], c["k"])
    return search(_t(c["queries"]), _t(c["feats"]))


def all_cases(mesh, cases: dict) -> dict:
    """Every case of one test file, in one group of ranks."""
    out = {"jax_modules": jax_modules()}
    for name, c in cases.items():
        out[name] = globals()[c.pop("fn")](mesh, c)
    return out


def run_gated_unsharded(c: dict) -> dict:
    """gated_cases' sequence in one process, the reference."""
    bdg = build_block_dense(c["idx"], c["mask"], c["ew"], block=c["block"],
                            table_pad=c["table_pad"], device="cpu")
    cfg = c["cfg"]
    params = params_from_numpy(c["params"], "cpu")
    fpad = bdg.pad_features(_t(c["feats"]))
    zeros = torch.zeros_like(fpad)

    def value_and_grad(keep=None):
        req = [{k: (v.detach().requires_grad_(True) if torch.is_tensor(v) else
                    {kk: vv.detach().requires_grad_(True) for kk, vv in v.items()})
                for k, v in layer.items()} for layer in params]
        if keep is None:
            loss = gated.gated_graph_transformer_loss(req, cfg, fpad, bdg, zeros)
        else:
            loss = gated.gated_graph_transformer_loss_with_masks(req, cfg, fpad, bdg, keep, zeros)
        leaves = [t for layer in req for t in gated._flatten(layer)[1]]
        grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        return loss.detach(), [gated._unflatten(gated._flatten(layer)[0],
                                                [next(it) for _ in gated._flatten(layer)[1]])
                               for layer in req]

    out = {}
    out["loss"], out["grads"] = value_and_grad()
    state = gated.gate_state_init(params, cfg, fpad, bdg)
    out["init"] = state
    steps = []
    for feats, max_resolve in c["steps"]:
        y, state, nres = gated.gated_graph_transformer_step(
            params, cfg, bdg.pad_features(_t(feats)), bdg, state, max_resolve=max_resolve)
        steps.append((y, state, nres))
    out["steps"] = steps
    out["masked_loss"], out["masked_grads"] = value_and_grad(state["keep"])
    return out


def multihost_rank(rank: int, world: int, port: int, directory: str, out_path: str):
    """A process brought up by initialize_multihost (rank 0 from its
    arguments, the others from the WORLD_SIZE/RANK/MASTER_* environment),
    then a checkpointer that every rank asks to save."""
    import json
    import os

    import torch.distributed as dist

    from ruvector_tpu_torch.parallel.multihost import TrainStateCheckpointer, initialize_multihost

    torch.set_num_threads(1)
    if rank == 0:
        up = initialize_multihost(f"127.0.0.1:{port}", world, 0, device="cpu")
    else:
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        up = initialize_multihost(device="cpu")
    total = torch.tensor([float(rank + 1)])
    dist.all_reduce(total)
    saved = TrainStateCheckpointer(directory, every_steps=1).maybe_save(
        1, {"w": torch.full((2,), float(rank))})
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"up": up, "world": world, "sum": float(total[0]), "saved": saved,
                   "jax_modules": jax_modules()}, f)
