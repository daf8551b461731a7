"""Mamba (selective SSM) layer (port of ruvector_tpu/transformer/mamba.py).

Reference: ruvector-mincut-gated-transformer/src/mamba.rs — in_proj ->
(x, z); causal conv1d; input-dependent (delta, B, C); softplus + clamped
delta; selective scan h' = exp(delta A) h + delta B x, y = C h + D x;
gated y silu(z); out_proj. The sequence form runs the step over time on
the host (the reference's lax.scan); the step is the decode form.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ruvector_tpu_torch.convert import params_from_numpy
from ruvector_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int = 128
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 8
    dt_min: float = 1e-3
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.d_model * self.expand

    @staticmethod
    def micro() -> "MambaConfig":
        return MambaConfig(d_model=128, d_state=8, d_conv=4, expand=2, dt_rank=8)

    @staticmethod
    def baseline() -> "MambaConfig":
        return MambaConfig(d_model=256, d_state=16, d_conv=4, expand=2, dt_rank=16)


@dataclasses.dataclass(frozen=True)
class MambaState:
    conv_state: torch.Tensor    # [d_conv - 1, d_inner] past inputs for conv
    ssm_state: torch.Tensor     # [d_inner, d_state]


def mamba_state_init(cfg: MambaConfig, device=None) -> MambaState:
    dev = resolve_device(device)
    return MambaState(
        conv_state=torch.zeros(cfg.d_conv - 1, cfg.d_inner, device=dev),
        ssm_state=torch.zeros(cfg.d_inner, cfg.d_state, device=dev),
    )


def mamba_init(init, cfg: MambaConfig, device=None) -> dict:
    """Random weights from a torch.Generator, or a numpy pytree in the JAX
    layout (e.g. weights JAX initialised) loaded onto `device`."""
    dev = resolve_device(device)
    if not isinstance(init, torch.Generator):
        return params_from_numpy(init, dev)
    di, ds, dm, dr = cfg.d_inner, cfg.d_state, cfg.d_model, cfg.dt_rank

    def normal(*shape):
        return torch.randn(shape, generator=init, device=init.device).to(dev)

    def scale(i, o):
        return (2.0 / (i + o)) ** 0.5

    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(di, ds)
    return {
        "in_proj": scale(dm, 2 * di) * normal(dm, 2 * di),
        "conv1d": 0.1 * normal(cfg.d_conv, di),
        "x_proj": scale(di, dr + 2 * ds) * normal(di, dr + 2 * ds),
        "dt_proj": scale(dr, di) * normal(dr, di),
        # A initialized negative-log-spaced (S4D-real); stored as log
        "a_log": torch.log(a),
        "d": torch.ones(di, device=dev),
        "out_proj": scale(di, dm) * normal(di, dm),
    }


def mamba_step(
    cfg: MambaConfig, weights: dict, x: torch.Tensor, state: MambaState
) -> tuple[torch.Tensor, MambaState]:
    """One token step (mamba.rs:235-312). x [d_model] -> (y [d_model], state)."""
    xz = x @ weights["in_proj"]                        # [2*d_inner]
    x_in, z = torch.split(xz, cfg.d_inner)

    # causal conv1d over (conv_state, x_in)
    window = torch.cat([state.conv_state, x_in[None, :]], dim=0)   # [d_conv, di]
    x_conv = F.silu(torch.sum(window * weights["conv1d"], dim=0))
    new_conv_state = window[1:]

    params = x_conv @ weights["x_proj"]
    dt_in = params[: cfg.dt_rank]
    b = params[cfg.dt_rank: cfg.dt_rank + cfg.d_state]
    c = params[cfg.dt_rank + cfg.d_state:]

    # jax.nn.softplus is logaddexp(x, 0) (torch's softplus switches to x above 20)
    delta = torch.logaddexp(dt_in @ weights["dt_proj"], torch.zeros((), device=x.device))
    delta = torch.clamp(delta, cfg.dt_min, cfg.dt_max)    # [d_inner]

    a = -torch.exp(weights["a_log"])                     # [di, ds]
    da = torch.exp(delta[:, None] * a)                   # [di, ds]
    new_ssm = da * state.ssm_state + delta[:, None] * b[None, :] * x_conv[:, None]
    y = torch.sum(new_ssm * c[None, :], dim=-1) + weights["d"] * x_conv

    out = (y * F.silu(z)) @ weights["out_proj"]
    return out, MambaState(conv_state=new_conv_state, ssm_state=new_ssm)


def mamba_forward_sequence(
    cfg: MambaConfig, weights: dict, x: torch.Tensor
) -> torch.Tensor:
    """[T, d_model] -> [T, d_model], the step over time (mamba.rs:315-330)."""
    state = mamba_state_init(cfg, x.device)
    ys = []
    for t in range(x.shape[0]):
        y, state = mamba_step(cfg, weights, x[t], state)
        ys.append(y)
    return torch.stack(ys)
