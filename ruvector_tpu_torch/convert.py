"""Parameter trees between numpy (the JAX layout) and torch tensors.

A JAX parameter pytree converted with `np.asarray` on every leaf (nested
dicts and lists of arrays, linear kernels `[in, out]`) maps one to one
onto the port's parameters: the same nesting and keys, each leaf a
tensor. Parity tests hand JAX-initialised parameters over this way; the
port never reproduces `jax.random`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device


def _leaf_to_tensor(x, device: torch.device) -> torch.Tensor:
    arr = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 (what JAX hands numpy): reinterpret the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: Any, device: str | torch.device | None = None) -> Any:
    """Numpy pytree (JAX layout) -> the same tree of tensors on `device`."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _leaf_to_tensor(node, dev)

    return conv(tree)


def to_numpy(x) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def params_to_numpy(tree: Any) -> Any:
    """Tree of tensors -> numpy pytree (JAX layout). bfloat16 leaves widen
    to float32 (exact), since numpy has no bfloat16 of its own."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        t = node.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return conv(tree)
