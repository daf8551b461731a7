"""Tensor parallelism for transformer layers: Megatron-style sharding
(port of ruvector_tpu/parallel/tp.py).

Attention heads and FFN hidden units are split over the ranks, with one
all-reduce per sublayer:
- wq/wk/wv [D, H*hd] split by columns (each rank owns H/S heads)
- wo [H*hd, D] split by rows (matching the heads) -> all-reduce
- FFN w1 [D, F] split by columns, w2 [F, D] by rows -> all-reduce
LayerNorms and activations are replicated: activations stay [T, D] on
every rank and only the two all-reduces cross ranks.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.nn.core import make_generator
from ruvector_tpu_torch.ops.kernels.gated_block_layer import gelu_tanh
from ruvector_tpu_torch.parallel.mesh import Mesh, local_slice


@dataclasses.dataclass(frozen=True)
class TpLayerConfig:
    hidden: int
    heads: int
    head_dim: int
    ffn: int
    causal: bool = True
    eps: float = 1e-5


def tp_layer_init(seed, cfg: TpLayerConfig, device=None) -> dict:
    """Whole (unsplit) parameters: normal * sqrt(2 / (in + out)) kernels,
    unit LayerNorms, from a seed or torch.Generator, on `device`."""
    dev = resolve_device(device)
    g = make_generator(seed)
    d, hds, f = cfg.hidden, cfg.heads * cfg.head_dim, cfg.ffn

    def init(i, o):
        return (torch.randn(i, o, generator=g) * math.sqrt(2.0 / (i + o))).to(dev)

    def ln():
        return {"gamma": torch.ones(d, device=dev), "beta": torch.zeros(d, device=dev)}

    return {"wq": init(d, hds), "wk": init(d, hds), "wv": init(d, hds), "wo": init(hds, d),
            "w1": init(d, f), "w2": init(f, d), "ln1": ln(), "ln2": ln()}


def tp_param_specs(axis_name: str = "nodes") -> dict:
    """The split of each parameter (column or row, per Megatron) as a
    partition-spec tuple (parallel/mesh.local_slice)."""
    col, row = (None, axis_name), (axis_name, None)
    return {"wq": col, "wk": col, "wv": col, "wo": row, "w1": col, "w2": row,
            "ln1": {"gamma": (), "beta": ()}, "ln2": {"gamma": (), "beta": ()}}


def _ln(p, x, eps):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]


def _attention(h, wq, wk, wv, heads, hd, causal):
    """Softmax attention of h over itself with the given projections:
    [T, heads*hd] before the output projection."""
    s = h.shape[0]
    q, k, v = ((h @ w).reshape(s, heads, hd) for w in (wq, wk, wv))
    scores = torch.einsum("qhd,khd->hqk", q, k) / torch.sqrt(
        torch.tensor(float(hd), dtype=torch.float32, device=h.device))
    if causal:
        tril = torch.tril(torch.ones((s, s), dtype=torch.bool, device=h.device))
        scores = torch.where(tril[None], scores, torch.full_like(scores, -torch.inf))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("hqk,khd->qhd", w, v).reshape(s, heads * hd)


def make_tp_layer_forward(cfg: TpLayerConfig, mesh: Mesh):
    """forward(params, x [T, D]) -> [T, D] on this rank, heads and FFN split
    over the ranks; params are whole, each rank reads its slices. Exactly
    two all-reduces per layer."""
    if cfg.heads % mesh.size:
        raise ValueError("heads must divide over the ranks")
    lh = cfg.heads // mesh.size
    specs = tp_param_specs(mesh.axis_name)

    def forward(params, x):
        p = {k: local_slice(params[k], specs[k], mesh) for k in ("wq", "wk", "wv", "wo",
                                                                   "w1", "w2")}
        h = _ln(params["ln1"], x, cfg.eps)
        attn = _attention(h, p["wq"], p["wk"], p["wv"], lh, cfg.head_dim, cfg.causal)
        x = x + mesh.all_reduce(attn @ p["wo"])
        h = _ln(params["ln2"], x, cfg.eps)
        return x + mesh.all_reduce(gelu_tanh(h @ p["w1"]) @ p["w2"])

    return forward


def reference_tp_layer_forward(params, cfg: TpLayerConfig, x):
    """The same layer in one process (the parity oracle)."""
    h = _ln(params["ln1"], x, cfg.eps)
    attn = _attention(h, params["wq"], params["wk"], params["wv"], cfg.heads, cfg.head_dim,
                      cfg.causal)
    x = x + attn @ params["wo"]
    h = _ln(params["ln2"], x, cfg.eps)
    return x + gelu_tanh(h @ params["w1"]) @ params["w2"]
