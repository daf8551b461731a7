"""Functional building blocks: Linear, LayerNorm, MHA, GRUCell
(port of ruvector_tpu/nn/core.py:21-148).

Parameters are plain dicts of tensors in the JAX layout: a linear kernel
is `[in, out]` and the layer computes `x @ W + b` — not `nn.Linear`'s
`[out, in]`. Initialisation draws from a `torch.Generator` (Xavier/Glorot
normal, zero bias) on the CPU and moves the result to `device`, so a seed
gives the same weights on every device; it does not reproduce
`jax.random`, and parity tests load JAX parameters instead.
"""

from __future__ import annotations

import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.ops.segment import masked_softmax


def make_generator(seed: int | torch.Generator) -> torch.Generator:
    """A CPU generator from a seed (a generator passes through)."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device="cpu").manual_seed(int(seed))


def xavier_normal(gen, in_dim: int, out_dim: int, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """Glorot-normal [in, out] kernel: std = sqrt(2/(in+out))."""
    scale = (2.0 / (in_dim + out_dim)) ** 0.5
    w = torch.randn((in_dim, out_dim), generator=make_generator(gen))
    return (scale * w).to(device=resolve_device(device), dtype=dtype)


def he_normal(gen, in_dim: int, out_dim: int, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """He-normal [in, out] kernel: std = sqrt(2/in)."""
    scale = (2.0 / in_dim) ** 0.5
    w = torch.randn((in_dim, out_dim), generator=make_generator(gen))
    return (scale * w).to(device=resolve_device(device), dtype=dtype)


# --- Linear -----------------------------------------------------------------

def linear_init(gen, in_dim: int, out_dim: int, device=None,
                dtype=torch.float32) -> dict:
    dev = resolve_device(device)
    return {
        "kernel": xavier_normal(gen, in_dim, out_dim, dev, dtype),
        "bias": torch.zeros((out_dim,), device=dev, dtype=dtype),
    }


def linear_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W + b over any leading batch dims."""
    return torch.matmul(x, params["kernel"]) + params["bias"]


# --- LayerNorm --------------------------------------------------------------

def layer_norm_init(dim: int, device=None, dtype=torch.float32) -> dict:
    dev = resolve_device(device)
    return {"gamma": torch.ones((dim,), device=dev, dtype=dtype),
            "beta": torch.zeros((dim,), device=dev, dtype=dtype)}


def layer_norm_apply(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x - mu) / sqrt(var + eps) * g + b over the last axis, biased variance."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * params["gamma"] + params["beta"]


# --- Multi-head attention over neighbors ------------------------------------

def mha_init(gen, embed_dim: int, num_heads: int, device=None,
             dtype=torch.float32) -> dict:
    if embed_dim % num_heads != 0:
        raise ValueError(
            f"embed_dim ({embed_dim}) must be divisible by num_heads ({num_heads})")
    g = make_generator(gen)
    return {name: linear_init(g, embed_dim, embed_dim, device, dtype)
            for name in ("q", "k", "v", "out")}


def mha_apply(params: dict, query: torch.Tensor, keys: torch.Tensor,
              values: torch.Tensor, mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Batched neighbor MHA: query [N, D] over keys/values [N, M, D] with
    mask [N, M]; scores scaled by 1/sqrt(head_dim), eps-guarded masked
    softmax. Returns [N, D]."""
    n, m, d = keys.shape
    hd = d // num_heads
    q = linear_apply(params["q"], query).reshape(n, num_heads, hd)
    k = linear_apply(params["k"], keys).reshape(n, m, num_heads, hd)
    v = linear_apply(params["v"], values).reshape(n, m, num_heads, hd)
    scores = torch.einsum("nhd,nmhd->nhm", q, k) * (1.0 / hd ** 0.5)
    attn = masked_softmax(scores, mask[:, None, :], dim=-1)
    out = torch.einsum("nhm,nmhd->nhd", attn, v).reshape(n, d)
    return linear_apply(params["out"], out)


# --- GRU cell ---------------------------------------------------------------

def gru_init(gen, input_dim: int, hidden_dim: int, device=None,
             dtype=torch.float32) -> dict:
    g = make_generator(gen)
    dims = {"w": input_dim, "u": hidden_dim}
    return {f"{kind}_{gate}": linear_init(g, dims[kind], hidden_dim, device, dtype)
            for gate in ("z", "r", "h") for kind in ("w", "u")}


def gru_apply(params: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """z = sig(W_z x + U_z h); r = sig(W_r x + U_r h);
    h~ = tanh(W_h x + U_h (r * h)); h' = (1 - z) * h + z * h~.
    The hidden state of the RuvectorLayer's GRU is the node message."""
    hd = h.shape[-1]
    w3 = torch.cat([params["w_z"]["kernel"], params["w_r"]["kernel"],
                    params["w_h"]["kernel"]], dim=1)
    b3 = torch.cat([params["w_z"]["bias"], params["w_r"]["bias"],
                    params["w_h"]["bias"]])
    u2 = torch.cat([params["u_z"]["kernel"], params["u_r"]["kernel"]], dim=1)
    ub2 = torch.cat([params["u_z"]["bias"], params["u_r"]["bias"]])
    wx = torch.matmul(x, w3) + b3
    uh = torch.matmul(h, u2) + ub2
    z = torch.sigmoid(wx[..., :hd] + uh[..., :hd])
    r = torch.sigmoid(wx[..., hd:2 * hd] + uh[..., hd:])
    h_tilde = torch.tanh(wx[..., 2 * hd:] + linear_apply(params["u_h"], r * h))
    return (1.0 - z) * h + z * h_tilde
