"""Device resolution for the port's entry points.

Every entry point that creates tensors takes a `device` argument. It
defaults to the CUDA card; running on the CPU must be asked for
explicitly (`device="cpu"`, as the CPU tests do). When no card is present
and the CPU was not asked for, the entry point raises instead of quietly
running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the torch device an entry point runs on (default: `cuda`).

    Raises RuntimeError when a CUDA device is requested (explicitly or by
    default) and torch sees no card.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ruvector_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev


def block_until_ready(tree):
    """Wait until the work that produces the tensors of `tree` (a tensor, or
    dicts, lists and tuples of them) has finished on their devices, as
    `jax.block_until_ready` does; returns `tree`. CUDA launches return
    before the card has run them, so a host clock read after a call
    measures its enqueue unless this comes first. CPU tensors need no wait."""
    stack, devices = [tree], set()
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, torch.Tensor) and node.device.type == "cuda":
            devices.add(node.device)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree
