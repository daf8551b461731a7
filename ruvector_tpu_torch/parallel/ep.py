"""Expert parallelism: a mixture-of-experts FFN with the experts split
over the ranks (port of ruvector_tpu/parallel/ep.py).

Dense dispatch: a one-hot einsum builds per-expert token buckets, each
rank runs only its own experts' FFNs, and one all-reduce reassembles the
combined output. Activations are replicated (the serving regime), so no
all-to-all is needed. No token is dropped, so the result equals the
unsplit oracle's.
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
class EpConfig:
    hidden: int
    ffn: int
    num_experts: int          # must be a multiple of the number of ranks


def ep_init(seed, cfg: EpConfig, device=None) -> dict:
    """Router and per-expert FFN weights (stacked on a leading expert
    axis), from a seed or torch.Generator, on `device`."""
    dev = resolve_device(device)
    g = make_generator(seed)
    e, d, f = cfg.num_experts, cfg.hidden, cfg.ffn
    scale1 = math.sqrt(2.0 / (d + f))
    return {"router": (torch.randn(d, e, generator=g) * math.sqrt(1.0 / d)).to(dev),
            "w1": (torch.randn(e, d, f, generator=g) * scale1).to(dev),
            "w2": (torch.randn(e, f, d, generator=g) * scale1).to(dev)}


def _expert_ffn(w1, w2, x):
    """Batched over a leading expert axis: x [E, T, D] -> [E, T, D]."""
    return torch.bmm(gelu_tanh(torch.bmm(x, w1)), w2)


def _route(router, x, num_experts):
    """Top-1 routing: (one-hot assignment [T, E], gate value [T])."""
    logits = x @ router
    assign = torch.argmax(logits, dim=-1)
    gate_val = torch.gather(torch.softmax(logits, dim=-1), 1, assign[:, None])[:, 0]
    return torch.nn.functional.one_hot(assign, num_experts).to(x.dtype), gate_val


def make_ep_forward(cfg: EpConfig, mesh: Mesh):
    """forward(params, x [T, D]) -> [T, D] on this rank: top-1 routing, the
    rank's experts only, one all-reduce. params are whole; each rank reads
    its experts' slices."""
    if cfg.num_experts % mesh.size:
        raise ValueError("num_experts must be a multiple of the number of ranks")
    le = cfg.num_experts // mesh.size
    lo = mesh.rank * le

    def forward(params, x):
        onehot, gate_val = _route(params["router"], x, cfg.num_experts)
        w1 = local_slice(params["w1"], (mesh.axis_name,), mesh)
        w2 = local_slice(params["w2"], (mesh.axis_name,), mesh)
        local_oh = onehot[:, lo:lo + le]
        mine = torch.einsum("te,td->etd", local_oh, x)                # [le, T, D]
        combined = torch.einsum("etd,te->td", _expert_ffn(w1, w2, mine), local_oh)
        return mesh.all_reduce(combined) * gate_val[:, None]

    return forward


def reference_ep_forward(params, cfg: EpConfig, x):
    """Unsplit oracle: the same top-1 routing and gated expert FFN."""
    onehot, gate_val = _route(params["router"], x, cfg.num_experts)
    outs = _expert_ffn(params["w1"], params["w2"],
                       x.expand(cfg.num_experts, *x.shape).contiguous())
    return torch.einsum("etd,te->td", outs, onehot) * gate_val[:, None]
