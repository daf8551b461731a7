"""Model weights made on the device from the run's seed, in one draw.

Kernels are Glorot normal (std sqrt(2 / (in + out))), as the port's own
initialisers draw them; biases and the LayerNorms' beta get 0.02 N(0, 1)
and their gamma 1 + 0.05 N(0, 1), so that a trained model's offsets are
exercised too. Float32, in the port's layout ([in, out] kernels), which
both the port and the references take.
"""

from __future__ import annotations

import torch

from portbench.graphgen import TAG_WEIGHTS, generator


class _Pool:
    """Consecutive slices of one standard-normal draw."""

    def __init__(self, numel: int, seed: int, device):
        gen = generator(seed, TAG_WEIGHTS, device)
        self.flat = torch.randn(numel, generator=gen, device=device)
        self.at = 0

    def take(self, *shape: int) -> torch.Tensor:
        n = 1
        for s in shape:
            n *= s
        out = self.flat[self.at:self.at + n].reshape(shape)
        self.at += n
        return out


def _linear(pool: _Pool, i: int, o: int) -> dict:
    return {"kernel": pool.take(i, o) * (2.0 / (i + o)) ** 0.5,
            "bias": 0.02 * pool.take(o)}


def _norm(pool: _Pool, d: int) -> dict:
    return {"gamma": 1.0 + 0.05 * pool.take(d), "beta": 0.02 * pool.take(d)}


def gated_params(seed: int, d: int, ffn_mult: int, layers: int, device) -> list[dict]:
    """Config 5's layers: wq, wk, wv, wo [d, d]; w_gnn, ffn_in, ffn_out
    linears; ln1, ln_g, ln2 LayerNorms (ruvector_tpu_torch's
    gated_graph_transformer_init layout)."""
    f = ffn_mult * d
    per_layer = 5 * d * d + d + 2 * d * f + f + d + 6 * d
    pool = _Pool(layers * per_layer, seed, device)
    out = []
    for _ in range(layers):
        p = {name: pool.take(d, d) * (1.0 / d) ** 0.5 for name in ("wq", "wk", "wv", "wo")}
        p["w_gnn"] = _linear(pool, d, d)
        p["ffn_in"] = _linear(pool, d, f)
        p["ffn_out"] = _linear(pool, f, d)
        for name in ("ln1", "ln_g", "ln2"):
            p[name] = _norm(pool, d)
        out.append(p)
    return out


def ruvector_params(seed: int, d_in: int, d: int, device) -> dict:
    """The RuvectorLayer: w_msg, w_agg, the GRU's six linears, the MHA's q,
    k, v and out, and the output LayerNorm (ruvector_layer_init's layout)."""
    numel = (d_in * d + d) + 11 * (d * d + d) + 2 * d
    pool = _Pool(numel, seed, device)
    return {
        "w_msg": _linear(pool, d_in, d),
        "w_agg": _linear(pool, d, d),
        "gru": {f"{kind}_{gate}": _linear(pool, d, d) for gate in ("z", "r", "h")
                for kind in ("w", "u")},
        "attn": {name: _linear(pool, d, d) for name in ("q", "k", "v", "out")},
        "norm": _norm(pool, d),
    }
