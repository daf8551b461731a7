"""Two-tier LoRA adapters: MicroLoRA (rank 1-2) and BaseLoRA (rank 4-16)
(port of ruvector_tpu/sona/lora.py).

Reference: sona/src/lora.rs — MicroLoRA (:23-260: deterministic golden-ratio
down init, zero up init, scale 1/sqrt(rank), accumulate-then-apply with
flush threshold) and BaseLoRA per-layer adapters.

The adapter state (`down`, `up`, `grad_up`) is host numpy, as in the JAX
package: accumulation is control-plane work, O(rank·hidden) per signal.
The forward y = x + scale·(x@down)@up runs in float32 on the adapter's
device over any leading dims, so the instant path amortizes over
concurrent queries.
"""

from __future__ import annotations

import numpy as np
import torch

from ruvector_tpu_torch.device import resolve_device
from ruvector_tpu_torch.sona.types import LearningSignal


def lora_forward(x: torch.Tensor, down: torch.Tensor, up: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """x + scale·((x @ down) @ up) in float32 over any leading dims."""
    x = x.float()
    return x + scale * ((x @ down) @ up)


def _golden_init(hidden_dim: int, rank: int) -> np.ndarray:
    """Deterministic low-discrepancy init (lora.rs:62-68)."""
    i = np.arange(hidden_dim * rank, dtype=np.float32)
    x = (i * 0.618_034) % 1.0
    return ((x - 0.5) * 0.02).reshape(hidden_dim, rank)


class _DeviceCopy:
    """The device copy of one host array, refreshed when the array's
    contents change. Callers overwrite `up` in place (`+=`) or replace it
    (`FederatedAggregator.apply`, `import_lora`), so the copy is keyed on
    the contents, compared with a host snapshot on every call."""

    def __init__(self, device: torch.device):
        self.device = device
        self._host: np.ndarray | None = None
        self._dev: torch.Tensor | None = None

    def get(self, arr: np.ndarray) -> torch.Tensor:
        if self._host is None or not np.array_equal(self._host, arr):
            self._host = np.array(arr, np.float32)
            self._dev = torch.tensor(self._host, device=self.device)
        return self._dev


def _as_input(x, device: torch.device) -> torch.Tensor:
    """x on the adapter's device (numpy arrays and tensors elsewhere are copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


class MicroLoRA:
    """Rank-1/2 instant adapter with gradient accumulation."""

    def __init__(self, hidden_dim: int, rank: int = 2, device=None):
        if not 1 <= rank <= 2:
            raise ValueError(f"MicroLoRA rank must be 1-2, got {rank}")
        self.device = resolve_device(device)
        self.hidden_dim = hidden_dim
        self.rank = rank
        self.scale = 1.0 / (rank ** 0.5)
        self.down = _golden_init(hidden_dim, rank)        # [H, r]
        self.up = np.zeros((rank, hidden_dim), np.float32)
        self.grad_up = np.zeros_like(self.up)
        self.update_count = 0
        self._down_dev = _DeviceCopy(self.device)
        self._up_dev = _DeviceCopy(self.device)

    def forward(self, x) -> torch.Tensor:
        """y = x + scale·(x@down)@up over any leading batch dims, on the
        adapter's device."""
        return lora_forward(_as_input(x, self.device), self._down_dev.get(self.down),
                            self._up_dev.get(self.up), self.scale)

    def accumulate_gradient(self, signal: LearningSignal):
        """grad_up[r] += gradient_estimate * quality (lora.rs:192-210)."""
        g = np.asarray(signal.gradient_estimate, np.float32)
        if g.shape[0] != self.hidden_dim:
            return
        self.grad_up += g[None, :] * signal.quality_score
        self.update_count += 1

    def apply_accumulated(self, learning_rate: float):
        """up += lr/count · grad_up; reset accumulators (lora.rs:213-230)."""
        if self.update_count == 0:
            return
        self.up += self.grad_up * (learning_rate / self.update_count)
        self.grad_up.fill(0.0)
        self.update_count = 0

    def reset(self):
        self.up.fill(0.0)
        self.grad_up.fill(0.0)
        self.update_count = 0

    @property
    def param_count(self) -> int:
        return self.down.size + self.up.size


class BaseLoRA:
    """Per-layer rank-16 background adapters (lora.rs BaseLoRA)."""

    def __init__(self, hidden_dim: int, num_layers: int, rank: int = 16, device=None):
        self.device = resolve_device(device)
        self.hidden_dim = hidden_dim
        self.rank = rank
        self.num_layers = num_layers
        self.scale = 1.0 / (rank ** 0.5)
        self.down = [
            _golden_init(hidden_dim, rank) for _ in range(num_layers)
        ]
        self.up = [
            np.zeros((rank, hidden_dim), np.float32) for _ in range(num_layers)
        ]
        self._down_dev = [_DeviceCopy(self.device) for _ in range(num_layers)]
        self._up_dev = [_DeviceCopy(self.device) for _ in range(num_layers)]

    def forward_layer(self, layer_idx: int, x) -> torch.Tensor:
        return lora_forward(_as_input(x, self.device),
                            self._down_dev[layer_idx].get(self.down[layer_idx]),
                            self._up_dev[layer_idx].get(self.up[layer_idx]), self.scale)

    def update_from_pattern(self, layer_idx: int, centroid: np.ndarray,
                            quality: float, lr: float):
        """Background consolidation: nudge the layer adapter toward
        reproducing the pattern direction (rank-1 update on `up`)."""
        c = np.asarray(centroid, np.float32)
        if c.shape[0] != self.hidden_dim:
            return
        norm = np.linalg.norm(c)
        if norm < 1e-8:
            return
        d = c / norm
        proj = self.down[layer_idx].T @ d            # [r]
        self.up[layer_idx] += lr * quality * np.outer(proj, d)

    def apply_gradients(self, layer_idx: int, grad_up: np.ndarray, lr: float):
        self.up[layer_idx] += lr * grad_up

    @property
    def param_count(self) -> int:
        return sum(d.size for d in self.down) + sum(u.size for u in self.up)
